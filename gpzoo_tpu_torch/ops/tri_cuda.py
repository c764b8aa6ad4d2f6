"""Triangular contraction c = Luᵀã on Hopper: kernels 1 and 2 of the port,
and kernels 6 and 7, the backward of kernel 1.

Ports ``gpzoo_tpu/ops/tri_pallas.py``: :func:`tri_sq_colsum_fused`
(``csrc/tri.cu`` ``tri_sq_colsum_c_f32``, c null) computes colsum((Luᵀa)²)
without writing c; :func:`tri_t_matmul` (``tri_t_matmul_f32``) writes c.
Both run at float32 accuracy on the TF32 tensor cores (3xTF32): a staging pass
writes Luᵀ and aᵀ K-major, split into TF32 hi and lo parts
(:func:`stage_plain` is its plain version), then each product is
lo·hi + hi·lo + hi·hi into a float32 accumulator. Each wrapper launches
its kernels for a CUDA tensor and takes the plain panel-blocked form of
:mod:`gpzoo_tpu_torch.ops.tri_blocked` for a CPU tensor; anything else
raises. ``launches`` on each wrapper counts its calls on the card. ``a``
is shared by every factor, (M, B) as in the north-star projection, or per
factor, (L, M, B) as in the MGGP W-form step's a = W·Kzx.

:class:`TriSqColsum` is the differentiable op the training loss calls.
Lu is treated as structurally lower-triangular: the kernels never read its
strict upper triangle and the returned dLu is tril-masked (exact for any
tril-consuming parameterization such as ``lower_cholesky``). Its forward
keeps c: :func:`tri_sq_colsum_fwd_c` (kernel 1 keeping c, the same loop
storing each row tile's c beside the column sums). Its backward ports JAX's
``_fused_bwd`` (tri_pallas.py:320, the vjp of the panel-blocked colsum) by
one of two routes. Where a is shared, (M, B), and takes no gradient (the
north-star projection, the fast leg's ã with Z and the kernel frozen), it is
one launch, :func:`tri_dlu_from_c` (kernel 6 reading c: dLu = tril(a·dcᵀ)
with dc = 2c·g formed from c in its operand loads, so no dc is written).
Elsewhere (a per-factor a, or a trained one) dLu is :func:`tri_dc_from_c`
(the scale pass: dc = 2c·g, stored split into TF32 hi and lo in the layout
kernel 6 reads, :class:`DcOperand`: one pass of 16-byte rows, no dcᵀ),
then :func:`tri_dlu` (kernel 6, dLu = tril(a·dcᵀ)), and da is one launch,
:func:`tri_da_from_c` (kernel 7 reading c: da = Lu·dc over the lower triangle
with dcᵀ = 2g·cᵀ formed from c in its operand loads, per factor, or summed
over l for a shared a).
:func:`tri_dc` (kernel 2 with a dc = 2c·g epilogue, which reruns the
triangle for c) gives the scale pass's bits and runs on no path;
:func:`tri_da` (kernel 7 on a :class:`DcOperand`'s dcᵀ) runs in the backward
of kernel 2 only. The dc epilogue and kernels 6 and 7 read their operand A
(LuT, a's rows or c's, Lu's rows, c's tile transposed) in float32 and split
it into hi and lo in registers, 48 KB a stage where kernels 1 and 2 take 64.
Their plain versions (:func:`tri_sq_colsum_c_plain`,
:func:`tri_dc_from_c_plain`, :func:`tri_dc_plain`, :func:`tri_dlu_plain`,
:func:`tri_dlu_from_c_plain`, :func:`tri_da_plain`,
:func:`tri_da_from_c_plain`) keep the panels of JAX's vjp: the CPU route and
the card's reference.

:class:`TriTMatmul` makes :func:`tri_t_matmul` differentiable with JAX's
contract (``tri_pallas._tri_bwd``): dLu = tril(a·gᵀ) and da = Lu·g over
the lower triangle (summed over l for a shared a), for a dense cotangent g
(L, M, B). On the card :func:`tri_split` writes g in the layout of
:class:`DcOperand` and kernels 6 and 7 run on it unchanged; on the CPU
:func:`tri_t_matmul_bwd_plain` keeps JAX's panels.

:class:`TriKLTrace` is kernel 8, the KL trace tr(K⁻¹·Lu·Luᵀ) of every step
(JAX's XLA ``tri_blocked.tri_kl_trace``, which no Pallas kernel carries):
on the card ``tri_kl_trace_f32`` sums P∘Lu over the lower triangle, P =
K_s·Lu with K_s = (K⁻¹ + K⁻ᵀ)/2, and, where Lu trains per factor, keeps
P's lower triangle for the backward (a persistent grid with Lu read in
place; nothing is written above P's diagonal), which
``tri_kl_trace_scale_f32`` turns into dLu = tril(2g·P) in one pass
(:func:`tri_kl_trace_fwd_p`,
:func:`tri_kl_trace_scale`); ``tri_kl_trace_bwd_f32`` recomputes P instead
for one Lu under a per-factor K⁻¹ (:func:`tri_kl_trace_bwd`). On the CPU
the same steps are plain forms (:func:`tri_kl_trace_p_plain`,
:func:`tri_kl_trace_scale_plain`, :func:`tri_kl_trace_bwd_plain`; the
panel form of :mod:`gpzoo_tpu_torch.ops.tri_blocked` where nothing is
kept). dK⁻¹ = g·Lu·Luᵀ (summed over l for a shared K⁻¹) is one IEEE
product (:func:`tri_kl_trace_dk`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gpzoo_tpu_torch.ops import _build, tri_blocked

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
_C_ARGTYPES = [ctypes.c_void_p] + _ARGTYPES
_STAGE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_void_p])
_TILE = 128  # output tile side in csrc/tri.cu; M is padded to it
_B_ALIGN = 32  # floats: the row stride of dc and of kernel 6's staged a


def padded(m_dim):
    """M rounded up to the kernels' tile: the staged k and row extent."""
    return -(-m_dim // _TILE) * _TILE


def padded_b(b_dim):
    """B rounded up to 32 floats (128 bytes): the row stride of dc and of
    kernel 6's staged a, which TMA reads (it needs a multiple of 16 bytes;
    B = 129 floats is 516)."""
    return -(-b_dim // _B_ALIGN) * _B_ALIGN


def split_tf32(x):
    """(hi, lo) float32 with hi = tf32(x), rounded to nearest with ties
    away from zero (``cvt.rna.tf32.f32``: 10 mantissa bits kept), and
    lo = tf32(x − hi); hi + lo = x to 2⁻²² relative. Finite x only."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # adding half a TF32 ulp to the magnitude bits, then truncating,
        # rounds the magnitude half up: ties away from zero
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def stage_plain(lu, a):
    """The staging pass in plain PyTorch: ``(lut, at)`` with lut
    (2, L, Mp, Mp) = the hi and lo parts of LuT[l, m, k] = Lu[l, k, m] for
    k ≥ m, and at (2, La, B, Mp) = those of aT[l, b, k] = a[l, k, b]
    (La = 1 for a shared a), zero above the diagonal and in the padding
    to Mp = :func:`padded` (M)."""
    l_dim, m_dim, b_dim = _shapes(lu, a)
    mp = padded(m_dim)
    lut = lu.new_zeros((l_dim, mp, mp))
    lut[:, :m_dim, :m_dim] = torch.tril(lu).mT
    a3 = a if a.ndim == 3 else a[None]
    at = a.new_zeros((a3.shape[0], b_dim, mp))
    at[..., :m_dim] = a3.mT
    return torch.stack(split_tf32(lut)), torch.stack(split_tf32(at))


def _scratch(lu, a, lu_parts=2, dims=None):
    """The staged LuT (hi and lo, or whole for the dc epilogue: ``lu_parts``
    1) and aT (hi and lo); ``dims`` (L, M, B) if known."""
    l_dim, m_dim, b_dim = dims or _shapes(lu, a)
    mp = padded(m_dim)
    l_a = l_dim if a.ndim == 3 else 1
    return torch.empty(lu_parts * l_dim * mp * mp + 2 * l_a * b_dim * mp,
                       dtype=torch.float32, device=lu.device)


def _shapes(lu, a):
    """(L, M, B) of lu (L, M, M) and a (M, B) or (L, M, B); raises for any
    other pair. Each shape is read once: a small call's host time counts."""
    ls, as_ = lu.shape, a.shape
    if len(ls) != 3 or ls[1] != ls[2]:
        raise ValueError(f"lu must be (L, M, M), got {tuple(ls)}")
    if not (len(as_) == 2 or (len(as_) == 3 and as_[0] == ls[0])) or as_[-2] != ls[1]:
        raise ValueError(f"a must be (M, B) or (L, M, B) with L={ls[0]}, "
                         f"M={ls[1]}, got {tuple(as_)}")
    return ls[0], ls[1], as_[-1]


def _fits(name, shape, *counts):
    """Refuse a shape whose TMA row coordinates, 1-D grid or staging grid
    dimensions (each of ``counts``: (value, limit)) do not fit."""
    for value, limit in counts:
        if value >= limit:
            raise ValueError(f"{name}: shape {shape} exceeds the launch grid")


def _fits_kernel2(name, l_dim, m_dim, b_dim, a):
    """Kernels 1-2 (and the dc epilogue): TMA row coordinates and kernel
    2's 1-D grid are 32-bit, a factor is a grid dimension."""
    mp = padded(m_dim)
    _fits(name, (l_dim, m_dim, b_dim), (l_dim, 65536),
          (max(l_dim * mp, (l_dim if a.ndim == 3 else 1) * b_dim,
               (mp // _TILE) * l_dim * -(-b_dim // _TILE)), 2**31))


_entries = {}


def _entry(name, argtypes):
    """The C entry point ``name`` of tri.cu, its argument types set once."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.library("tri"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(t):
    """The current CUDA stream of t's device, as the raw handle the C
    entry points take (one call, where ``torch.cuda.current_stream`` builds
    a Stream object first: a small call's host time counts)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _launch(name, lu, a, out, scratch, dims=None, c=None):
    """Kernel 1 or 2 (or, with ``out`` None, the staging pass alone) into
    ``out``, staging into ``scratch``: the caller's, which is checked, or
    one :func:`_scratch` made for this call (``dims``, the (L, M, B) that
    :func:`_shapes` gave, passed with it). Kernel 1's entry
    (``tri_sq_colsum_c_f32``) also takes ``c``: the buffer it keeps c in,
    or None (a null pointer) for the colsum alone."""
    if dims is None:
        dims = _shapes(lu, a)
        _build.check_operands(name, lu=lu, a=a, scratch=scratch)
    else:
        _build.check_operands(name, lu=lu, a=a)
    l_dim, m_dim, b_dim = dims
    _fits_kernel2(name, l_dim, m_dim, b_dim, a)
    a_stride = m_dim * b_dim if a.ndim == 3 else 0
    ptrs = (lu.data_ptr(), a.data_ptr())
    if out is None:  # the staging pass alone
        fn = _entry(name, _STAGE_ARGTYPES)
        args = ptrs + (scratch.data_ptr(), l_dim, m_dim, b_dim, a_stride, _stream(lu))
    else:
        keeps = name == "tri_sq_colsum_c_f32"
        fn = _entry(name, _C_ARGTYPES if keeps else _ARGTYPES)
        c_ptr = ((None if c is None else c.data_ptr()),) if keeps else ()
        args = (ptrs + (out.data_ptr(),) + c_ptr
                + (l_dim, m_dim, b_dim, a_stride, scratch.data_ptr(), _stream(lu)))
    _build.check(fn(*args), name)


def stage(lu, a, scratch=None):
    """The staging pass alone on the card, into ``scratch`` (flat float32,
    allocated if None): returns ``(lut, at)`` laid out as
    :func:`stage_plain`'s. Blocks that the MMA loop never reads (k below
    the first row of a row tile) are left as ``scratch`` held them."""
    l_dim, m_dim, b_dim = _shapes(lu, a)
    if scratch is None:
        scratch = _scratch(lu, a)
    _launch("tri_stage_f32", lu, a, None, scratch)
    mp = padded(m_dim)
    n_lu = 2 * l_dim * mp * mp
    return (scratch[:n_lu].view(2, l_dim, mp, mp),
            scratch[n_lu:].view(2, -1, b_dim, mp))


def tri_sq_colsum_fused(lu, a):
    """out[l, b] = Σ_m (Σ_{k≥m} lu[l, k, m] a[(l,) k, b])² for lu (L, M, M)
    lower-triangular and a (M, B) or (L, M, B): kernel 1 on CUDA, the plain
    blocked form on CPU. Returns (L, B)."""
    dims = _shapes(lu, a)
    if lu.device.type == "cpu":
        return tri_blocked.tri_sq_colsum(lu, a)
    out = torch.empty((dims[0], dims[2]), dtype=lu.dtype, device=lu.device)
    _launch("tri_sq_colsum_c_f32", lu, a, out, _scratch(lu, a, dims=dims), dims)
    tri_sq_colsum_fused.launches += 1
    return out


tri_sq_colsum_fused.launches = 0


def tri_sq_colsum_c_plain(lu, a):
    """Kernel 1 keeping c in plain PyTorch: ``(colsum, c)``, c = Luᵀa
    (L, M, B) from :mod:`tri_blocked`'s panels, each computed once, and the
    colsum (L, B) of c² summed panel by panel in
    :func:`tri_blocked.tri_sq_colsum`'s order: its bits, and c those of
    :func:`tri_blocked.tri_t_matmul`."""
    parts = [torch.einsum("...km,...kn->...mn", lu[..., s:, s:e], a[..., s:, :])
             for s, e in tri_blocked._panels(lu.shape[-1])]
    out = None
    for c_p in parts:
        term = torch.sum(torch.square(c_p), dim=-2)
        out = term if out is None else out + term
    return out, parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def tri_sq_colsum_fwd_c(lu, a):
    """``(colsum, c)``: out[l, b] = Σ_m c[l, m, b]² (L, B) and c = Luᵀa
    (L, M, B) kept for the backward, for lu (L, M, M) lower-triangular and a
    (M, B) or (L, M, B): kernel 1 keeping c on the card (``launches``
    counts it; the colsum the bits of :func:`tri_sq_colsum_fused`, c those
    of :func:`tri_t_matmul_fwd`), :func:`tri_sq_colsum_c_plain` on the
    CPU."""
    dims = _shapes(lu, a)
    if lu.device.type == "cpu":
        _on_cpu("tri_sq_colsum_fwd_c", a=a)
        return tri_sq_colsum_c_plain(lu, a)
    out = torch.empty((dims[0], dims[2]), dtype=lu.dtype, device=lu.device)
    c = torch.empty(dims, dtype=lu.dtype, device=lu.device)
    _launch("tri_sq_colsum_c_f32", lu, a, out, _scratch(lu, a, dims=dims), dims, c=c)
    tri_sq_colsum_fwd_c.launches += 1
    return out, c


tri_sq_colsum_fwd_c.launches = 0


def tri_t_matmul_fwd(lu, a):
    """c[l, m, b] = Σ_{k≥m} lu[l, k, m] a[(l,) k, b] for a (M, B) or
    (L, M, B): kernel 2 on CUDA (counted in ``tri_t_matmul.launches``), the
    plain blocked form on CPU. Returns (L, M, B)."""
    dims = _shapes(lu, a)
    if lu.device.type == "cpu":
        return tri_blocked.tri_t_matmul(lu, a)
    out = torch.empty(dims, dtype=lu.dtype, device=lu.device)
    _launch("tri_t_matmul_f32", lu, a, out, _scratch(lu, a, dims=dims), dims)
    tri_t_matmul.launches += 1
    return out


def tri_t_matmul(lu, a):
    """Differentiable c = Luᵀa over the lower triangle of lu (L, M, M), for
    a (M, B) or (L, M, B): :class:`TriTMatmul`, or its forward alone
    (:func:`tri_t_matmul_fwd`) where no gradient is recorded. Returns
    (L, M, B). ``launches`` counts kernel 2's c store on the card."""
    if torch.is_grad_enabled() and (lu.requires_grad or a.requires_grad):
        return TriTMatmul.apply(lu, a)
    return tri_t_matmul_fwd(lu, a)


tri_t_matmul.launches = 0


class DcOperand(NamedTuple):
    """dc = 2c·g as :func:`tri_dc_from_c` (or :func:`tri_dc`) leaves it on
    the card for kernels 6 and 7, or a dense cotangent of c as
    :func:`tri_split` does: ``rows`` (2, L, M, Bp), the TF32 hi and lo parts
    of dc[l, m, b] with the row stride Bp = :func:`padded_b` (B) and zeros
    for b ≥ B, which kernel 6 reads; ``rows_t`` (2, L, B, Mp), those of dcᵀ
    with zeros for m ≥ M (Mp = :func:`padded` (M)), which :func:`tri_da`
    reads, or None where it does not run: every path's kernel 7 reads c
    (:func:`tri_da_from_c`), so only the backward of kernel 2 makes it;
    ``b`` = B. hi + lo = dc to 2⁻²²."""

    rows: torch.Tensor
    rows_t: torch.Tensor | None
    b: int

    def dense(self):
        """dc (L, M, B) in one float32 tensor."""
        return (self.rows[0] + self.rows[1])[..., :self.b]


def tri_dc_plain(lu, a, g):
    """dc[l, m, b] = 2 g[l, b] c[l, m, b], c = Luᵀa panel by panel (the
    cotangent of c in JAX's vjp of the panel-blocked colsum): lu (L, M, M),
    a (M, B) or (L, M, B), g (L, B). Returns (L, M, B)."""
    return tri_blocked.tri_t_matmul(lu, a) * (2 * g)[:, None, :]


def tri_dlu_plain(a, dc):
    """dLu = tril(a·dcᵀ) per factor as JAX's vjp forms it: column panel
    [s, e) (``tri_blocked._panels``) over rows k ≥ s only, then the
    strict upper triangle zeroed (the op's contract): a (M, B) or
    (L, M, B), dc (L, M, B). Returns (L, M, M)."""
    l_dim, m_dim, _ = dc.shape
    dlu = dc.new_zeros((l_dim, m_dim, m_dim))
    for s, e in tri_blocked._panels(m_dim):
        dlu[:, s:, s:e] = torch.tril(torch.matmul(a[..., s:, :], dc[:, s:e].mT))
    return dlu


def tri_da_plain(lu, dc, shared=False):
    """da[l, k, b] = Σ_{m≤k} Lu[l, k, m] dc[l, m, b] as JAX's vjp forms
    it: panel [s, e) of m over rows k ≥ s only, reading tril(Lu) alone.
    Returns (L, M, B), or for a shared a (``shared``) its sum over l,
    (M, B)."""
    l_dim, m_dim, b_dim = dc.shape
    spec = "lkm,lmb->kb" if shared else "lkm,lmb->lkb"
    da = dc.new_zeros((m_dim, b_dim) if shared else (l_dim, m_dim, b_dim))
    for s, e in tri_blocked._panels(m_dim):
        da[..., s:, :] += torch.einsum(spec, torch.tril(lu[:, s:, s:e]), dc[:, s:e])
    return da


def _on_cpu(name, **tensors):
    for what, t in tensors.items():
        if t.device.type != "cpu":
            raise ValueError(f"{name}: {what} is on {t.device}, the others on the CPU")


def tri_dc(lu, a, g, transposed=False):
    """dc = 2c·g, c = Luᵀa recomputed, for lu (L, M, M), a (M, B) or
    (L, M, B), g (L, B). On the card: kernel 2 with the dc epilogue,
    returning a :class:`DcOperand` (with dcᵀ if ``transposed``, for
    :func:`tri_da`). On the CPU: :func:`tri_dc_plain`, dc (L, M, B). No
    path runs it since kernel 1 keeps c (:func:`tri_dc_from_c`, the same
    bits)."""
    l_dim, m_dim, b_dim = _shapes(lu, a)
    if tuple(g.shape) != (l_dim, b_dim):
        raise ValueError(f"g must be (L, B) = {(l_dim, b_dim)}, got {tuple(g.shape)}")
    if lu.device.type == "cpu":
        _on_cpu("tri_dc", a=a, g=g)
        return tri_dc_plain(lu, a, g)
    _build.check_operands("tri_dc", lu=lu, a=a, g=g)
    _fits_kernel2("tri_dc", l_dim, m_dim, b_dim, a)
    rows = torch.empty((2, l_dim, m_dim, padded_b(b_dim)), dtype=torch.float32,
                       device=lu.device)
    rows_t = (torch.empty((2, l_dim, b_dim, padded(m_dim)), dtype=torch.float32,
                          device=lu.device) if transposed else None)
    fn = _entry("tri_dc_f32", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
    _build.check(fn(lu.data_ptr(), a.data_ptr(), g.data_ptr(), rows.data_ptr(),
                    None if rows_t is None else rows_t.data_ptr(), l_dim, m_dim, b_dim,
                    m_dim * b_dim if a.ndim == 3 else 0, _scratch(lu, a, 1).data_ptr(),
                    _stream(lu)), "tri_dc_f32")
    tri_dc.launches += 1
    return DcOperand(rows, rows_t, b_dim)


tri_dc.launches = 0


def tri_dlu(a, dc):
    """dLu = tril(a·dcᵀ) per factor, (L, M, M): kernel 6 on the card, for
    dc a :class:`DcOperand`, writing every element
    (zeros above the diagonal); :func:`tri_dlu_plain` on the CPU, for
    dc (L, M, B)."""
    if a.device.type == "cpu":
        if not isinstance(dc, torch.Tensor):
            raise TypeError("tri_dlu: on the CPU dc is tri_dc's (L, M, B) tensor")
        _on_cpu("tri_dlu", dc=dc)
        return tri_dlu_plain(a, dc)
    if not isinstance(dc, DcOperand):
        raise TypeError("tri_dlu: on the card dc is tri_dc's DcOperand")
    _, l_dim, m_dim, b_pad = dc.rows.shape
    b_dim = dc.b
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[0] == l_dim)) \
            or tuple(a.shape[-2:]) != (m_dim, b_dim) or b_pad != padded_b(b_dim):
        raise ValueError(f"tri_dlu: a must be (M, B) or (L, M, B) with dc's L={l_dim}, "
                         f"M={m_dim}, B={b_dim}, got {tuple(a.shape)}")
    _build.check_operands("tri_dlu", a=a, dc=dc.rows)
    l_a = l_dim if a.ndim == 3 else 1
    nrt = padded(m_dim) // _TILE
    _fits("tri_dlu", (l_dim, m_dim, b_dim), (m_dim, 65536), (l_a, 65536),
          (max(l_dim * nrt * (nrt + 1) // 2, l_dim * m_dim), 2**31))
    dlu = torch.empty((l_dim, m_dim, m_dim), dtype=torch.float32, device=a.device)
    # kernel 6 reads a's rows in place unless B is off a 16-byte row stride
    scratch = torch.empty(l_a * m_dim * b_pad if b_dim % 4 else 0, dtype=torch.float32,
                          device=a.device)
    fn = _entry("tri_dlu_f32", _ARGTYPES)
    _build.check(fn(a.data_ptr(), dc.rows.data_ptr(), dlu.data_ptr(), l_dim, m_dim, b_dim,
                    m_dim * b_dim if a.ndim == 3 else 0, scratch.data_ptr(), _stream(a)),
                 "tri_dlu_f32")
    tri_dlu.launches += 1
    return dlu


tri_dlu.launches = 0


def tri_da(lu, dc, shared=False):
    """da_l = Lu_l·dc_l over the lower triangle of Lu, (L, M, B), or for a
    shared a (``shared``) its sum over l, (M, B): kernel 7 on the card (the
    sum over l after it), for dc the :class:`DcOperand` of ``tri_dc(...,
    transposed=True)``; :func:`tri_da_plain` on the CPU, for dc
    (L, M, B)."""
    if lu.device.type == "cpu":
        if not isinstance(dc, torch.Tensor):
            raise TypeError("tri_da: on the CPU dc is tri_dc's (L, M, B) tensor")
        _on_cpu("tri_da", dc=dc)
        return tri_da_plain(lu, dc, shared=shared)
    if not isinstance(dc, DcOperand) or dc.rows_t is None:
        raise TypeError("tri_da: on the card dc is the DcOperand of "
                        "tri_dc(..., transposed=True)")
    _, l_dim, b_dim, m_pad = dc.rows_t.shape
    m_dim = lu.shape[-1]
    if tuple(lu.shape) != (l_dim, m_dim, m_dim) or m_pad != padded(m_dim):
        raise ValueError(f"tri_da: lu must be (L, M, M) with dc's L={l_dim} and "
                         f"padded M={m_pad}, got {tuple(lu.shape)}")
    _build.check_operands("tri_da", lu=lu, dc=dc.rows_t)
    nrt = m_pad // _TILE
    _fits("tri_da", (l_dim, m_dim, b_dim), (m_pad, 65536), (l_dim, 65536),
          (max(l_dim * m_pad, l_dim * b_dim, l_dim * nrt * -(-b_dim // _TILE)), 2**31))
    da = torch.empty((l_dim, m_dim, b_dim), dtype=torch.float32, device=lu.device)
    # Lu's rows staged, zeros above the diagonal (L, Mp, Mp): in float32, or
    # split into hi and lo where the grid is one wave or less
    one_wave = l_dim * nrt * -(-b_dim // _TILE) <= _sm_count(lu.device)
    scratch = torch.empty((2 if one_wave else 1) * l_dim * m_pad * m_pad,
                          dtype=torch.float32, device=lu.device)
    fn = _entry("tri_da_f32", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p, ctypes.c_void_p])
    _build.check(fn(lu.data_ptr(), dc.rows_t.data_ptr(), da.data_ptr(), l_dim, m_dim, b_dim,
                    scratch.data_ptr(), _stream(lu)), "tri_da_f32")
    tri_da.launches += 1
    return da.sum(0) if shared else da


tri_da.launches = 0


def tri_split_plain(g, transposed=False):
    """The split pass in plain PyTorch: g (L, M, B) as the
    :class:`DcOperand` that :func:`tri_split` writes on the card, the
    TF32 hi and lo parts of :func:`split_tf32` with zeros in the padding."""
    l_dim, m_dim, b_dim = g.shape
    rows = g.new_zeros((l_dim, m_dim, padded_b(b_dim)))
    rows[..., :b_dim] = g
    rows_t = None
    if transposed:
        rows_t = g.new_zeros((l_dim, b_dim, padded(m_dim)))
        rows_t[..., :m_dim] = g.mT
        rows_t = torch.stack(split_tf32(rows_t))
    return DcOperand(torch.stack(split_tf32(rows)), rows_t, b_dim)


def _split_run(name, x, g, transposed):
    """``tri_split_f32`` on the card: x (L, M, B) split into the
    :class:`DcOperand` layout (with xᵀ if ``transposed``), or, given g
    (L, B), scaled first by 2g into rows only; the caller checked the
    operands."""
    l_dim, m_dim, b_dim = x.shape
    _fits(name, (l_dim, m_dim, b_dim), (l_dim, 65536),
          (padded(m_dim) // 32, 65536), (padded_b(b_dim) // 32, 2**31),
          # the scale pass's blocks: 512 16-byte chunks of a row each
          (l_dim * m_dim * -(-padded_b(b_dim) // 2048), 2**31))
    rows = torch.empty((2, l_dim, m_dim, padded_b(b_dim)), dtype=torch.float32,
                       device=x.device)
    rows_t = (torch.empty((2, l_dim, b_dim, padded(m_dim)), dtype=torch.float32,
                          device=x.device) if transposed else None)
    fn = _entry("tri_split_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), None if g is None else g.data_ptr(), rows.data_ptr(),
                    None if rows_t is None else rows_t.data_ptr(), l_dim, m_dim, b_dim,
                    _stream(x)), "tri_split_f32")
    return DcOperand(rows, rows_t, b_dim)


def tri_split(g, transposed=False):
    """A dense cotangent g (L, M, B) of c as the :class:`DcOperand` that
    kernels 6 and 7 read (with gᵀ if ``transposed``, for :func:`tri_da`):
    ``tri_split_f32`` on the card, :func:`tri_split_plain` on the CPU."""
    if g.ndim != 3:
        raise ValueError(f"tri_split: g must be (L, M, B), got {tuple(g.shape)}")
    if g.device.type == "cpu":
        return tri_split_plain(g, transposed)
    _build.check_operands("tri_split", g=g)
    op = _split_run("tri_split", g, None, transposed)
    tri_split.launches += 1
    return op


tri_split.launches = 0


def tri_dc_from_c_plain(c, g):
    """dc[l, m, b] = 2 g[l, b] c[l, m, b] from the c that kernel 1 kept:
    :func:`tri_dc_plain`'s product, so from the same c the same bits.
    Returns (L, M, B)."""
    return c * (2 * g)[:, None, :]


def tri_dc_from_c(c, g, transposed=False):
    """The scale pass: dc = 2c·g from the c (L, M, B) that
    :func:`tri_sq_colsum_fwd_c` kept and the colsum's cotangent g (L, B).
    On the card ``tri_split_f32`` given g, which scales and splits in one
    pass of bytes (blocks of 512 16-byte chunks of a row), returning the
    :class:`DcOperand` that kernel 6 reads, rows only: the dc epilogue's
    rows, bit for bit (:func:`tri_dc`, which reruns the triangle for c). No
    path asks for dcᵀ, which kernel 7 reading c forms in its own loads, so
    ``transposed`` raises there. On the CPU: :func:`tri_dc_from_c_plain`, dc
    (L, M, B), whatever ``transposed``."""
    if c.ndim != 3 or tuple(g.shape) != (c.shape[0], c.shape[2]):
        raise ValueError(f"tri_dc_from_c: c must be (L, M, B) and g (L, B), got "
                         f"{tuple(c.shape)} and {tuple(g.shape)}")
    if c.device.type == "cpu":
        _on_cpu("tri_dc_from_c", g=g)
        return tri_dc_from_c_plain(c, g)
    if transposed:
        raise ValueError("tri_dc_from_c: the scale pass writes dc's rows only; kernel 7 "
                         "reading c (tri_da_from_c) forms dcᵀ")
    _build.check_operands("tri_dc_from_c", c=c, g=g)
    op = _split_run("tri_dc_from_c", c, g, False)
    tri_dc_from_c.launches += 1
    return op


tri_dc_from_c.launches = 0


def tri_dlu_from_c_plain(a, c, g):
    """Kernel 6 reading c in plain PyTorch: :func:`tri_dlu_plain` of
    :func:`tri_dc_from_c_plain`, the scale and kernel 6's panels, so the bits
    of that route. a (M, B), c (L, M, B), g (L, B); returns (L, M, M)."""
    return tri_dlu_plain(a, tri_dc_from_c_plain(c, g))


def tri_dlu_from_c(a, c, g):
    """dLu = tril(a·dcᵀ), dc = 2c·g, per factor, (L, M, M), for a shared a
    (M, B), the c (L, M, B) that :func:`tri_sq_colsum_fwd_c` kept and the
    colsum's cotangent g (L, B). On the card one C entry: a split into TF32
    hi and lo, then kernel 6 reading c (c scaled by 2g and split in its
    operand loads, no dc written; every element of dLu written, zeros above
    the diagonal), the bits of the scale pass followed by :func:`tri_dlu`
    (``launches`` counts the entry). On the CPU:
    :func:`tri_dlu_from_c_plain`."""
    if a.ndim != 2 or c.ndim != 3 or tuple(c.shape[1:]) != tuple(a.shape) \
            or tuple(g.shape) != (c.shape[0], c.shape[2]):
        raise ValueError(f"tri_dlu_from_c: a must be (M, B), c (L, M, B) and g (L, B), got "
                         f"{tuple(a.shape)}, {tuple(c.shape)} and {tuple(g.shape)}")
    if a.device.type == "cpu":
        _on_cpu("tri_dlu_from_c", c=c, g=g)
        return tri_dlu_from_c_plain(a, c, g)
    _build.check_operands("tri_dlu_from_c", a=a, c=c, g=g)
    l_dim, m_dim, b_dim = c.shape
    b_pad, nrt = padded_b(b_dim), padded(m_dim) // _TILE
    _fits("tri_dlu_from_c", (l_dim, m_dim, b_dim), (m_dim, 65536), (l_dim, 65536),
          (b_pad // 32, 2**31),
          (max(l_dim * nrt * (nrt + 1) // 2, l_dim * m_dim), 2**31))
    dlu = torch.empty((l_dim, m_dim, m_dim), dtype=torch.float32, device=a.device)
    # a's hi and lo rows, 2g in rows of Bp, and c's rows copied with the row
    # stride Bp where B is off a 16-byte row stride
    scratch = torch.empty((2 + (l_dim if b_dim % 4 else 0)) * m_dim * b_pad + l_dim * b_pad,
                          dtype=torch.float32, device=a.device)
    fn = _entry("tri_dlu_from_c_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2)
    _build.check(fn(a.data_ptr(), c.data_ptr(), g.data_ptr(), dlu.data_ptr(), l_dim, m_dim,
                    b_dim, scratch.data_ptr(), _stream(a)), "tri_dlu_from_c_f32")
    tri_dlu_from_c.launches += 1
    return dlu


tri_dlu_from_c.launches = 0


def tri_da_from_c_plain(lu, c, g, shared=False):
    """Kernel 7 reading c in plain PyTorch: :func:`tri_da_plain` of
    :func:`tri_dc_from_c_plain`, the scale and kernel 7's panels, so the bits
    of that route. lu (L, M, M), c (L, M, B), g (L, B); returns (L, M, B),
    or for a shared a (``shared``) its sum over l, (M, B)."""
    return tri_da_plain(lu, tri_dc_from_c_plain(c, g), shared=shared)


def tri_da_from_c(lu, c, g, shared=False):
    """da_l = Lu_l·dc_l over the lower triangle of Lu, dc = 2c·g, (L, M, B),
    or for a shared a (``shared``) its sum over l, (M, B), from lu
    (L, M, M), the c (L, M, B) that :func:`tri_sq_colsum_fwd_c` kept and the
    colsum's cotangent g (L, B). On the card one C entry: Lu's rows split
    into TF32 hi and lo, then kernel 7 reading c (c's tile read transposed,
    scaled by 2g and split in its operand loads, no dcᵀ written; every
    element of da written), the bits of :func:`tri_da` on the dc epilogue's
    dcᵀ (:func:`tri_dc`; ``launches`` counts the entry; a shared a's sum
    over l comes after it). On the CPU: :func:`tri_da_from_c_plain`."""
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2] or c.ndim != 3 \
            or tuple(c.shape[:2]) != tuple(lu.shape[:2]) \
            or tuple(g.shape) != (c.shape[0], c.shape[2]):
        raise ValueError(f"tri_da_from_c: lu must be (L, M, M), c (L, M, B) and g (L, B), got "
                         f"{tuple(lu.shape)}, {tuple(c.shape)} and {tuple(g.shape)}")
    if lu.device.type == "cpu":
        _on_cpu("tri_da_from_c", c=c, g=g)
        return tri_da_from_c_plain(lu, c, g, shared=shared)
    _build.check_operands("tri_da_from_c", lu=lu, c=c, g=g)
    l_dim, m_dim, b_dim = c.shape
    m_pad, b_pad = padded(m_dim), padded_b(b_dim)
    nrt, nct = m_pad // _TILE, -(-b_dim // _TILE)
    _fits("tri_da_from_c", (l_dim, m_dim, b_dim), (m_pad, 65536), (l_dim, 65536),
          (max(l_dim * m_pad, l_dim * b_dim, l_dim * nrt * nct), 2**31))
    da = torch.empty((l_dim, m_dim, b_dim), dtype=torch.float32, device=lu.device)
    # Lu's rows split, (L, Mp, Mp) twice, and c's rows copied with the row
    # stride Bp where B is off a 16-byte row stride
    scratch = torch.empty(2 * l_dim * m_pad * m_pad + (l_dim * m_dim * b_pad if b_dim % 4 else 0),
                          dtype=torch.float32, device=lu.device)
    fn = _entry("tri_da_from_c_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p] * 2)
    _build.check(fn(lu.data_ptr(), c.data_ptr(), g.data_ptr(), da.data_ptr(), l_dim, m_dim,
                    b_dim, scratch.data_ptr(), _stream(lu)), "tri_da_from_c_f32")
    tri_da_from_c.launches += 1
    return da.sum(0) if shared else da


tri_da_from_c.launches = 0


def tri_t_matmul_bwd_plain(lu, a, g, needs=(True, True)):
    """(dLu, da) of c = Luᵀa for the cotangent g (L, M, B), JAX's
    ``_tri_bwd`` panels (:func:`tri_dlu_plain`, :func:`tri_da_plain` with
    dc = g): dLu = tril(a·gᵀ), da = Lu·g over the lower triangle, summed
    over l for a shared a; None where ``needs`` is false."""
    return (tri_dlu_plain(a, g) if needs[0] else None,
            tri_da_plain(lu, g, shared=a.ndim == 2) if needs[1] else None)


def tri_t_matmul_bwd(lu, a, g, needs=(True, True)):
    """(dLu, da) of c = Luᵀa for the cotangent g (L, M, B), None where
    ``needs`` is false: on the card :func:`tri_split` (with gᵀ where da is
    needed), then kernel 6 (:func:`tri_dlu`) and kernel 7 (:func:`tri_da`);
    :func:`tri_t_matmul_bwd_plain` on the CPU."""
    l_dim, m_dim, b_dim = _shapes(lu, a)
    if tuple(g.shape) != (l_dim, m_dim, b_dim):
        raise ValueError(f"g must be (L, M, B) = {(l_dim, m_dim, b_dim)}, "
                         f"got {tuple(g.shape)}")
    if lu.device.type == "cpu":
        _on_cpu("tri_t_matmul_bwd", a=a, g=g)
        return tri_t_matmul_bwd_plain(lu, a, g, needs)
    if not any(needs):
        return None, None
    _build.check_operands("tri_t_matmul_bwd", lu=lu, a=a)
    op = tri_split(g.contiguous(), transposed=needs[1])
    return (tri_dlu(a, op) if needs[0] else None,
            tri_da(lu, op, shared=a.ndim == 2) if needs[1] else None)


class TriTMatmul(torch.autograd.Function):
    """c = Luᵀa with Lu structurally lower-triangular: the forward is
    :func:`tri_t_matmul_fwd` (kernel 2 on the card), the backward
    :func:`tri_t_matmul_bwd`, JAX's ``_tri_bwd`` (the returned dLu is
    tril(dense grad))."""

    @staticmethod
    def forward(ctx, lu, a):
        ctx.save_for_backward(lu, a)
        return tri_t_matmul_fwd(lu, a)

    @staticmethod
    def backward(ctx, g):
        lu, a = ctx.saved_tensors
        return tri_t_matmul_bwd(lu, a, g, ctx.needs_input_grad[:2])


class TriSqColsum(torch.autograd.Function):
    """colsum((Luᵀa)²) in two steps: the forward keeps c = Luᵀa
    (:func:`tri_sq_colsum_fwd_c`: kernel 1 keeping c on the card, 4·L·M·B
    bytes held between the two, in ``save_for_backward`` so that a
    checkpointed region's first run drops it); the backward for g (L, B) is
    JAX's ``_fused_bwd`` by one of two routes.

    - A shared a (M, B) that takes no gradient (the north-star projection;
      the fast leg's ã = K⁻¹Kzx with Z and the kernel frozen):
      :func:`tri_dlu_from_c`, one launch, kernel 6 reading c, which forms
      dc = 2c·g in its own operand loads; no dc is written.
    - Any other a (a per-factor a = W·Kzx, as the MGGP step and the hybrids
      train it, or a shared a that takes a gradient): where Lu needs a
      gradient, dc = 2c·g by the scale pass :func:`tri_dc_from_c` (one pass
      of bytes; dc's rows stored split in the layout of :class:`DcOperand`,
      2·4·L·M·B bytes, no dcᵀ), then dLu = tril(a·dcᵀ) by :func:`tri_dlu`
      (kernel 6); where a needs one, da_l = Lu_l·dc_l by
      :func:`tri_da_from_c` (kernel 7 reading c, which forms dcᵀ = 2g·cᵀ in
      its own operand loads; a shared a's da = Σ_l Lu_l·dc_l, which no path
      needs at full width).

    Kernels 6 and 7 each run the same triangle of L·B·M(M+1) FLOP as the
    forward, three TF32 products each: 7.6 ms at the north-star shape at 495
    TFLOP/s; the dc epilogue (:func:`tri_dc`), which reran it for c, runs on
    no path, and neither does kernel 7 on a :class:`DcOperand`
    (:func:`tri_da`, the backward of kernel 2). Every route gives the same
    bits. On the CPU the same steps are plain forms."""

    @staticmethod
    def forward(ctx, lu, a):
        out, c = tri_sq_colsum_fwd_c(lu, a)
        ctx.save_for_backward(lu, a, c)
        return out

    @staticmethod
    def backward(ctx, g):
        lu, a, c = ctx.saved_tensors
        need_lu, need_a = ctx.needs_input_grad[:2]
        g = g.contiguous()
        if a.ndim == 2 and not need_a:
            return tri_dlu_from_c(a, c, g), None
        dlu = tri_dlu(a, tri_dc_from_c(c, g)) if need_lu else None
        da = tri_da_from_c(lu, c, g, shared=a.ndim == 2) if need_a else None
        return dlu, da


def tri_sq_colsum(lu, a):
    """Differentiable colsum((Luᵀa)²): lu (L, M, M), a (M, B) or
    (L, M, B) → (L, B): :class:`TriSqColsum` where a gradient is recorded
    (it keeps c), else :func:`tri_sq_colsum_fused` (kernel 1 alone, nothing
    kept)."""
    if torch.is_grad_enabled() and (lu.requires_grad or a.requires_grad):
        return TriSqColsum.apply(lu, a)
    return tri_sq_colsum_fused(lu, a)


def _trace_shapes(k_inv, lu):
    """(L, M, Lk, Llu) of the trace's operands: K⁻¹ (M, M) shared (Lk = 1)
    or (L, M, M) per factor; Lu (M, M) or (Llu, M, M), Llu 1 or L. Raises
    for any other pair."""
    ks, ls = tuple(k_inv.shape), tuple(lu.shape)
    lu3 = ls if len(ls) == 3 else (1,) + ls
    l_k = ks[0] if len(ks) == 3 else 1
    if not (len(ks) in (2, 3) and len(ls) in (2, 3) and ks[-1] == ks[-2]
            and lu3[1:] == ks[-2:] and (len(ks) == 2 or lu3[0] in (1, l_k))):
        raise ValueError(f"tri_kl_trace: k_inv must be (M, M) or (L, M, M), and lu (M, M), "
                         f"(1, M, M) or (L, M, M) with the same M and L, got {ks} and {ls}")
    return max(l_k, lu3[0]), ks[-1], l_k, lu3[0]


def _pairs(m_dim):
    """Kernel 8's blocks a factor: the 128-tiles (rt, ct) with ct >= rt."""
    nrt = padded(m_dim) // _TILE
    return nrt * (nrt + 1) // 2


def tri_kl_trace_plain(k_inv, lu):
    """tr(K⁻¹·Lu·Luᵀ) per factor in closed form: Σ over the lower triangle
    of P∘Lu, P = K_s·tril(Lu), K_s = (K⁻¹ + K⁻ᵀ)/2 (the trace of K⁻¹ and of
    K_s agree, Lu·Luᵀ being symmetric). Returns (L,)."""
    _trace_shapes(k_inv, lu)
    lu3 = torch.tril(lu if lu.ndim == 3 else lu[None])
    k_s = (k_inv + k_inv.mT) / 2
    return torch.sum(torch.matmul(k_s, lu3) * lu3, dim=(-2, -1))


def tri_kl_trace_p_plain(k_inv, lu):
    """The forward that keeps P, in closed form: ``(trace, P)``, P =
    tril(K_s·tril(Lu)) (L, M, M) with exact zeros above the diagonal, and
    the trace (L,) Σ P∘Lu, as :func:`tri_kl_trace_plain`; for a per-factor
    Lu (Llu = L: (L, M, M), or (M, M) and (1, M, M) with L = 1)."""
    l_dim, _, _, l_lu = _trace_shapes(k_inv, lu)
    if l_lu != l_dim:
        raise ValueError(f"tri_kl_trace: P is kept for a per-factor Lu, got {tuple(lu.shape)} "
                         f"under K⁻¹ {tuple(k_inv.shape)}")
    lu3 = torch.tril(lu if lu.ndim == 3 else lu[None])
    p = torch.matmul((k_inv + k_inv.mT) / 2, lu3).tril_()
    return torch.sum(p * lu3, dim=(-2, -1)), p


def tri_kl_trace_scale_plain(p, g):
    """dLu = tril(2g_l·P_l) from the kept P (L, M, M) and the cotangent g
    (L,): the backward's second step in plain form, (L, M, M)."""
    return (p * (2 * g)[:, None, None]).tril_()


def tri_kl_trace_bwd_plain(k_inv, lu, g, p=None):
    """dLu of tr(K⁻¹·Lu·Luᵀ) for the cotangent g (L,), in closed form and
    in one buffer, the shape of lu: from the forward's kept ``p``
    (:func:`tri_kl_trace_p_plain`) where given, tril(2g·P) by
    :func:`tri_kl_trace_scale_plain`; else tril(g_l (K⁻¹ + K⁻ᵀ) Lu_l) =
    tril(2 g_l K_s,l Lu_l), JAX's gradient on the lower triangle and zeros
    above, the product by K⁻ᵀ accumulated into that by K⁻¹; for one Lu under
    a per-factor K⁻¹, tril(2 K_c Lu) with K_c = Σ_l g_l K_s,l."""
    if p is not None:
        return tri_kl_trace_scale_plain(p, g).reshape(lu.shape)
    l_dim, _, _, l_lu = _trace_shapes(k_inv, lu)
    lu3 = torch.tril(lu if lu.ndim == 3 else lu[None])
    if l_lu == 1 and l_dim > 1:
        k_c = torch.einsum("l,lij->ij", g, k_inv)
        out = torch.matmul(k_c + k_c.mT, lu3)
    else:
        out = torch.matmul(k_inv, lu3)
        out.baddbmm_(k_inv.mT.expand(out.shape), lu3).mul_(g[:, None, None])
    return out.tril_().reshape(lu.shape)


def tri_kl_trace_dk(k_inv, lu, g):
    """dK⁻¹ of tr(K⁻¹·Lu·Luᵀ) for the cotangent g (L,) and a lower Lu (where
    JAX's panels give exactly this): g_l·Lu_l·Lu_lᵀ, (L, M, M), or its sum
    over l for a shared K⁻¹, (M, M), as one product [g_l Lu_l]_l·[Lu_l]_lᵀ
    over the (M, L·M) rows. IEEE float32 on the card, as the panel einsums
    it replaces. The shape of k_inv."""
    _, m_dim, _, l_lu = _trace_shapes(k_inv, lu)
    lu3 = lu if lu.ndim == 3 else lu[None]
    if k_inv.ndim == 2:
        rows = lu3.permute(1, 0, 2).reshape(m_dim, -1)
        scaled = (lu3 * g[:, None, None]).permute(1, 0, 2).reshape(m_dim, -1)
        return torch.matmul(scaled, rows.mT)
    if l_lu == 1:
        return torch.matmul(lu3, lu3.mT) * g[:, None, None]
    return torch.matmul(lu3 * g[:, None, None], lu3.mT)


# the C entries of kernel 8: the forward (its P null where none is kept),
# the recomputing backward and the scale pass
_TRACE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
_TRACE_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
_TRACE_SCALE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _trace_run(name, k_inv, lu, dims, g=None, keep_p=False):
    """Kernel 8 on the card for the (L, M, Lk, Llu) ``dims`` of
    :func:`_trace_shapes`: the forward (``g`` None; returns the trace (L,)
    and, with ``keep_p``, P (L, M, M), else None) or the recomputing
    backward (returns dLu, the shape of lu). One allocation holds the
    staging and, for the forward, the tiles' partial sums."""
    l_dim, m_dim, l_k, l_lu = dims
    if not k_inv.is_contiguous() and k_inv.mT.is_contiguous():
        # K_s is the same for K⁻¹ and K⁻ᵀ: a transposed K⁻¹ (as
        # cholesky_inverse hands it back) is read as the contiguous K⁻ᵀ
        k_inv = k_inv.mT
    _build.check_operands(name, k_inv=k_inv, lu=lu, **({} if g is None else {"g": g}))
    mp = padded(m_dim)
    # K_s hi and lo: one slab a factor, or one for a shared K⁻¹ (and for
    # the backward of one Lu under a per-factor K⁻¹: K_c)
    l_s = 1 if g is not None and l_lu == 1 and l_dim > 1 else l_k
    pairs = _pairs(m_dim)
    _fits(name, (l_dim, m_dim), (l_dim, 65536), (l_lu + l_s, 65536), (mp, 65536),
          (max(l_dim * pairs, max(l_lu, l_k) * mp), 2**31))
    if g is not None:
        # LuT whole, K_s hi and lo
        scratch = torch.empty((l_lu + 2 * l_s) * mp * mp, dtype=torch.float32,
                              device=lu.device)
        out = torch.empty(lu.shape, dtype=torch.float32, device=lu.device)
        _build.check(_entry(name, _TRACE_BWD_ARGTYPES)(
            k_inv.data_ptr(), lu.data_ptr(), g.data_ptr(), out.data_ptr(), l_dim, m_dim, l_k,
            l_lu, scratch.data_ptr(), _stream(lu)), name)
        return out
    out = torch.empty((l_dim,), dtype=torch.float32, device=lu.device)
    p = (torch.empty((l_dim, m_dim, m_dim), dtype=torch.float32, device=lu.device)
         if keep_p else None)
    if keep_p:
        # K_s hi and lo, then Lu's rows staged with the row stride Mp where
        # TMA cannot read them in place (a row off 16 bytes, or lu's start)
        copy = m_dim % 4 != 0 or lu.data_ptr() % 16 != 0
        n_stage = (2 * l_k + (l_dim if copy else 0)) * mp * mp
    else:
        n_stage = (l_lu + 2 * l_k) * mp * mp  # LuT whole, K_s hi and lo
    # then a double a tile: an even count of floats before it keeps it
    # 8-byte aligned
    scratch = torch.empty(n_stage + 2 * l_dim * pairs, dtype=torch.float32, device=lu.device)
    # a factor's tiles, then the persistent kernel's tile counter and its blocks
    tickets = _build.tickets(lu.device, l_dim + 2, name)
    _build.check(_entry(name, _TRACE_ARGTYPES)(
        k_inv.data_ptr(), lu.data_ptr(), out.data_ptr(), None if p is None else p.data_ptr(),
        tickets.data_ptr(), l_dim, m_dim, l_k, l_lu, scratch.data_ptr(), _stream(lu)), name)
    return out, p


def _forward(k_inv, lu, dims, keep_p):
    """``(trace (L,), P (L, M, M) or None)`` for the ``dims`` of
    :func:`_trace_shapes`, P kept where ``keep_p``: on the card kernel 8
    (counted in ``tri_kl_trace_fwd_p.launches`` with P, else in
    ``tri_kl_trace_fwd.launches``); on the CPU :func:`tri_kl_trace_p_plain`,
    or the panel form :func:`tri_blocked.tri_kl_trace` without P."""
    if lu.device.type == "cpu":
        _on_cpu("tri_kl_trace", k_inv=k_inv)
        return tri_kl_trace_p_plain(k_inv, lu) if keep_p else (
            tri_blocked.tri_kl_trace(k_inv, lu), None)
    out = _trace_run("tri_kl_trace_f32", k_inv, lu, dims, keep_p=keep_p)
    (tri_kl_trace_fwd_p if keep_p else tri_kl_trace_fwd).launches += 1
    return out


def tri_kl_trace_fwd(k_inv, lu):
    """tr(K⁻¹·Lu·Luᵀ) per factor, (L,), for K⁻¹ (M, M) or (L, M, M) and a
    lower-triangular Lu (M, M), (1, M, M) or (L, M, M): kernel 8 on the
    card (``launches`` counts it), the panel form
    :func:`tri_blocked.tri_kl_trace` on the CPU."""
    return _forward(k_inv, lu, _trace_shapes(k_inv, lu), False)[0]


tri_kl_trace_fwd.launches = 0


def tri_kl_trace_fwd_p(k_inv, lu):
    """``(trace, P)``: the trace (L,) and P = K_s·Lu (L, M, M) on and below
    the diagonal, the forward that keeps P for the backward, for a
    per-factor Lu (Llu = L): kernel 8 keeping P on the card (``launches``
    counts it; P's upper triangle is left as ``torch.empty`` made it, which
    :func:`tri_kl_trace_scale` never reads), :func:`tri_kl_trace_p_plain`
    on the CPU (zeros above the diagonal)."""
    dims = _trace_shapes(k_inv, lu)
    if dims[3] != dims[0]:
        raise ValueError(f"tri_kl_trace_fwd_p: P is kept for a per-factor Lu, got "
                         f"{tuple(lu.shape)} under K⁻¹ {tuple(k_inv.shape)}")
    return _forward(k_inv, lu, dims, True)


tri_kl_trace_fwd_p.launches = 0


def tri_kl_trace_scale(p, g):
    """dLu = tril(2g_l·P_l), (L, M, M), a new tensor, from the P that
    :func:`tri_kl_trace_fwd_p` kept and the cotangent g (L,): the scale
    kernel on the card (``launches`` counts it),
    :func:`tri_kl_trace_scale_plain` on the CPU."""
    if p.ndim != 3 or p.shape[1] != p.shape[2] or tuple(g.shape) != (p.shape[0],):
        raise ValueError(f"tri_kl_trace_scale: p must be (L, M, M) and g (L,), got "
                         f"{tuple(p.shape)} and {tuple(g.shape)}")
    if p.device.type == "cpu":
        _on_cpu("tri_kl_trace_scale", g=g)
        return tri_kl_trace_scale_plain(p, g)
    _build.check_operands("tri_kl_trace_scale", p=p, g=g)
    l_dim, m_dim, _ = p.shape
    _fits("tri_kl_trace_scale", (l_dim, m_dim), (-(-l_dim * m_dim // 8), 2**31))
    out = torch.empty((l_dim, m_dim, m_dim), dtype=torch.float32, device=p.device)
    _build.check(_entry("tri_kl_trace_scale_f32", _TRACE_SCALE_ARGTYPES)(
        p.data_ptr(), g.data_ptr(), out.data_ptr(), l_dim, m_dim, _stream(p)),
        "tri_kl_trace_scale_f32")
    tri_kl_trace_scale.launches += 1
    return out


tri_kl_trace_scale.launches = 0


def _backward(k_inv, lu, g, p, dims):
    """dLu for the cotangent g (L,), the shape of lu: from the kept ``p``
    (:func:`tri_kl_trace_scale`) where given, else recomputed (kernel 8's
    recomputing backward on the card, counted in
    ``tri_kl_trace_bwd.launches``); :func:`tri_kl_trace_bwd_plain` on the
    CPU."""
    if lu.device.type == "cpu":
        _on_cpu("tri_kl_trace_bwd", k_inv=k_inv, g=g)
        return tri_kl_trace_bwd_plain(k_inv, lu, g, p)
    if p is not None:
        return tri_kl_trace_scale(p, g).reshape(lu.shape)
    out = _trace_run("tri_kl_trace_bwd_f32", k_inv, lu, dims, g)
    tri_kl_trace_bwd.launches += 1
    return out


def tri_kl_trace_bwd(k_inv, lu, g):
    """dLu of tr(K⁻¹·Lu·Luᵀ) for the cotangent g (L,), zeros above the
    diagonal, the shape of lu, with P recomputed: kernel 8's recomputing
    backward on the card (``launches`` counts it),
    :func:`tri_kl_trace_bwd_plain` on the CPU."""
    dims = _trace_shapes(k_inv, lu)
    if tuple(g.shape) != (dims[0],):
        raise ValueError(f"tri_kl_trace_bwd: g must be (L,) = ({dims[0]},), got "
                         f"{tuple(g.shape)}")
    return _backward(k_inv, lu, g.contiguous(), None, dims)


tri_kl_trace_bwd.launches = 0


class TriKLTrace(torch.autograd.Function):
    """tr(K⁻¹·Lu·Luᵀ) per factor with Lu structurally lower-triangular, in
    two steps where Lu takes a gradient and is per factor (Llu = L): the
    forward keeps P = K_s·Lu on and below the diagonal
    (:func:`tri_kl_trace_fwd_p`: 4·L·M² bytes held between the two) and the
    backward scales it, dLu =
    tril(2g·P) (:func:`tri_kl_trace_scale`, one pass of bytes), JAX's
    gradient on the lower triangle. One Lu under a per-factor K⁻¹ (whose P
    would be L products) keeps nothing, and its backward recomputes
    (:func:`tri_kl_trace_bwd`'s kernel); where only K⁻¹ trains, no P is
    made. dK⁻¹ = :func:`tri_kl_trace_dk`. The CPU takes the same steps in
    plain forms."""

    @staticmethod
    def forward(ctx, k_inv, lu):
        dims = _trace_shapes(k_inv, lu)
        out, p = _forward(k_inv, lu, dims, ctx.needs_input_grad[1] and dims[3] == dims[0])
        ctx.dims = dims
        ctx.save_for_backward(k_inv, lu, p)
        return out

    @staticmethod
    def backward(ctx, g):
        k_inv, lu, p = ctx.saved_tensors
        need_k, need_lu = ctx.needs_input_grad[:2]
        dlu = _backward(k_inv, lu, g.contiguous(), p, ctx.dims) if need_lu else None
        return (tri_kl_trace_dk(k_inv, lu, g) if need_k else None), dlu


def tri_kl_trace(k_inv, lu):
    """Differentiable tr(K⁻¹·Lu·Luᵀ) per factor: k_inv (M, M) shared or
    (L, M, M); lu (M, M), (1, M, M) (one Lu, expanded over a per-factor
    K⁻¹) or (L, M, M), lower-triangular. Returns (L,): :class:`TriKLTrace`,
    or its forward alone where no gradient is recorded."""
    if torch.is_grad_enabled() and (k_inv.requires_grad or lu.requires_grad):
        return TriKLTrace.apply(k_inv, lu)
    return tri_kl_trace_fwd(k_inv, lu)
