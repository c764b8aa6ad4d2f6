"""Triangular contraction c = Luᵀã on Hopper: kernels 1 and 2 of the port.

Ports ``gpzoo_tpu/ops/tri_pallas.py``: :func:`tri_sq_colsum_fused`
(``csrc/tri.cu`` ``tri_sq_colsum_f32``) computes colsum((Luᵀa)²) without
writing c; :func:`tri_t_matmul` (``tri_t_matmul_f32``) writes c. Each
wrapper launches its kernel for a CUDA tensor and takes the plain
panel-blocked form of :mod:`gpzoo_tpu_torch.ops.tri_blocked` for a CPU
tensor; anything else raises. ``launches`` on each wrapper counts its
kernel launches. ``a`` is shared by every factor, (M, B) as in the
north-star projection, or per factor, (L, M, B) as in the MGGP W-form
step's a = W·Kzx.

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
             + [ctypes.c_longlong, ctypes.c_void_p])
_TILE = 64  # output tile side in csrc/tri.cu


def _shapes(lu, a):
    if lu.ndim != 3 or lu.shape[1] != lu.shape[2]:
        raise ValueError(f"lu must be (L, M, M), got {tuple(lu.shape)}")
    if not (a.ndim == 2 or (a.ndim == 3 and a.shape[0] == lu.shape[0])) \
            or a.shape[-2] != lu.shape[1]:
        raise ValueError(f"a must be (M, B) or (L, M, B) with L={lu.shape[0]}, "
                         f"M={lu.shape[1]}, got {tuple(a.shape)}")
    return lu.shape[0], lu.shape[1], a.shape[-1]


def _launch(name, lu, a, out):
    l_dim, m_dim, b_dim = _shapes(lu, a)
    for t, what in ((lu, "lu"), (a, "a")):
        if t.device.type != "cuda" or t.device != out.device:
            raise ValueError(f"{name}: {what} must be on {out.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if max(m_dim, b_dim) >= 2**31 or l_dim > 65535 or -(-m_dim // _TILE) > 65535:
        raise ValueError(f"{name}: shape (L={l_dim}, M={m_dim}, B={b_dim}) "
                         "exceeds the launch grid")
    a_stride = m_dim * b_dim if a.ndim == 3 else 0
    fn = getattr(_build.library("tri"), name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check(fn(lu.data_ptr(), a.data_ptr(), out.data_ptr(),
                    l_dim, m_dim, b_dim, a_stride, stream), name)


def tri_sq_colsum_fused(lu, a):
    """out[l, b] = Σ_m (Σ_{k≥m} lu[l, k, m] a[(l,) k, b])² for lu (L, M, M)
    lower-triangular and a (M, B) or (L, M, B): kernel 1 on CUDA, the plain
    blocked form on CPU. Returns (L, B)."""
    if lu.device.type == "cpu":
        _shapes(lu, a)
        return tri_blocked.tri_sq_colsum(lu, a)
    out = torch.empty((lu.shape[0], a.shape[-1]), dtype=lu.dtype,
                      device=lu.device)
    _launch("tri_sq_colsum_f32", lu, a, out)
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
    _launch("tri_t_matmul_f32", lu, a, out)
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
