"""Triangular contraction c = Luᵀã on Hopper: kernels 1 and 2 of the port.

Ports ``gpzoo_tpu/ops/tri_pallas.py``: :func:`tri_sq_colsum_fused`
(``csrc/tri.cu`` ``tri_sq_colsum_f32``) computes colsum((Luᵀa)²) without
writing c; :func:`tri_t_matmul` (``tri_t_matmul_f32``) writes c. Both run
at float32 accuracy on the TF32 tensor cores (3xTF32): a staging pass
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
tril-consuming parameterization such as ``lower_cholesky``).
"""

from __future__ import annotations

import ctypes

import torch

from gpzoo_tpu_torch.ops import _build, tri_blocked

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])
_STAGE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_void_p])
_TILE = 128  # output tile side in csrc/tri.cu; M is padded to it


def padded(m_dim):
    """M rounded up to the kernels' tile: the staged k and row extent."""
    return -(-m_dim // _TILE) * _TILE


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


def _scratch(lu, a):
    l_dim, m_dim, b_dim = _shapes(lu, a)
    mp = padded(m_dim)
    l_a = l_dim if a.ndim == 3 else 1
    return torch.empty(2 * l_dim * mp * mp + 2 * l_a * b_dim * mp,
                       dtype=torch.float32, device=lu.device)


def _shapes(lu, a):
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2]:
        raise ValueError(f"lu must be (L, M, M), got {tuple(lu.shape)}")
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[0] == lu.shape[0])) \
            or a.shape[-2] != lu.shape[1]:
        raise ValueError(f"a must be (M, B) or (L, M, B) with L={lu.shape[0]}, "
                         f"M={lu.shape[1]}, got {tuple(a.shape)}")
    return lu.shape[0], lu.shape[1], a.shape[-1]


def _launch(name, lu, a, out, scratch):
    l_dim, m_dim, b_dim = _shapes(lu, a)
    for t, what in ((lu, "lu"), (a, "a")):
        if t.device.type != "cuda" or t.device != scratch.device:
            raise ValueError(f"{name}: {what} must be on {scratch.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    # TMA row coordinates and the 1-D grid of tri_t_matmul are 32-bit
    mp = padded(m_dim)
    rows = max(l_dim * mp, (l_dim if a.ndim == 3 else 1) * b_dim,
               (mp // _TILE) * l_dim * -(-b_dim // _TILE))
    if rows >= 2**31 or l_dim > 65535:
        raise ValueError(f"{name}: shape (L={l_dim}, M={m_dim}, B={b_dim}) "
                         "exceeds the launch grid")
    a_stride = m_dim * b_dim if a.ndim == 3 else 0
    fn = getattr(_build.library("tri"), name)
    fn.argtypes = _STAGE_ARGTYPES if out is None else _ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(scratch.device).cuda_stream
    ptrs = (lu.data_ptr(), a.data_ptr())
    if out is None:  # the staging pass alone
        args = ptrs + (scratch.data_ptr(), l_dim, m_dim, b_dim, a_stride, stream)
    else:
        args = ptrs + (out.data_ptr(), l_dim, m_dim, b_dim, a_stride,
                       scratch.data_ptr(), stream)
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
    if lu.device.type == "cpu":
        _shapes(lu, a)
        return tri_blocked.tri_sq_colsum(lu, a)
    out = torch.empty((lu.shape[0], a.shape[-1]), dtype=lu.dtype,
                      device=lu.device)
    _launch("tri_sq_colsum_f32", lu, a, out, _scratch(lu, a))
    tri_sq_colsum_fused.launches += 1
    return out


tri_sq_colsum_fused.launches = 0


def tri_t_matmul(lu, a):
    """c[l, m, b] = Σ_{k≥m} lu[l, k, m] a[(l,) k, b] for a (M, B) or
    (L, M, B): kernel 2 on CUDA, the plain blocked form on CPU. Returns
    (L, M, B)."""
    if lu.device.type == "cpu":
        _shapes(lu, a)
        return tri_blocked.tri_t_matmul(lu, a)
    out = torch.empty((lu.shape[0], lu.shape[1], a.shape[-1]),
                      dtype=lu.dtype, device=lu.device)
    _launch("tri_t_matmul_f32", lu, a, out, _scratch(lu, a))
    tri_t_matmul.launches += 1
    return out


tri_t_matmul.launches = 0


class TriSqColsum(torch.autograd.Function):
    """colsum((Luᵀa)²) with the c tensor kept out of memory in the forward.

    Backward for g (L, B): c is recomputed by :func:`tri_t_matmul`,
    dc = 2c·g is formed in place in c's buffer, then
    dLu = tril(a·dcᵀ) per factor as panel-blocked matmuls (column panel
    [s, e) only has rows k ≥ s), and, only when a needs a gradient,
    da = Σ_l Lu_l·dc_l for a shared a (the north-star projection, a
    constant there) or da_l = Lu_l·dc_l for a per-factor a (the MGGP step,
    where a = W·Kzx depends on the trained kernel).
    """

    @staticmethod
    def forward(ctx, lu, a):
        ctx.save_for_backward(lu, a)
        return tri_sq_colsum_fused(lu, a)

    @staticmethod
    def backward(ctx, g):
        lu, a = ctx.saved_tensors
        dc = tri_t_matmul(lu, a)
        dc.mul_(2.0 * g[:, None, :])
        dlu = da = None
        if ctx.needs_input_grad[0]:
            dlu = torch.zeros_like(lu)
            for s, e in tri_blocked._panels(lu.shape[-1]):
                dlu[:, s:, s:e] = torch.matmul(a[..., s:, :], dc[:, s:e].mT)
            dlu.tril_()
        if ctx.needs_input_grad[1]:
            da = (torch.einsum("lkm,lmb->kb", lu, dc) if a.ndim == 2
                  else torch.matmul(lu, dc))
        return dlu, da


def tri_sq_colsum(lu, a):
    """Differentiable colsum((Luᵀa)²): lu (L, M, M), a (M, B) or
    (L, M, B) → (L, B)."""
    return TriSqColsum.apply(lu, a)
