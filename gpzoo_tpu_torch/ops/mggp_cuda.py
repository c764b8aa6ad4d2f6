"""L-batched multi-group (MGGP) Gram on Hopper: kernel 4 of the port.

Ports ``gpzoo_tpu/ops/gram_pallas.py`` ``mggp_gram`` and its backward
``_mggp_gram_bwd``. :func:`mggp_gram_fwd` launches ``csrc/mggp.cu``
``mggp_gram_f32`` for CUDA tensors (its ``launches`` counts them) and takes
:func:`mggp_gram_plain`, the expanded-distance form of
``gram_pallas._mggp_gram_xla``, for CPU tensors. The two agree up to float
rounding of d² and g² near 0 (the kernel forms both directly from the
coordinates and embeddings).

:class:`MGGPGram` adds the backward in closed form, JAX's vjp of
``_mggp_gram_xla`` (:func:`mggp_gram_bwd_plain`): :func:`mggp_gram_bwd`
launches ``mggp_gram_bwd_f32`` for CUDA tensors (its own ``launches``),
which reads the cotangent once and writes the per-factor gradients of σ,
ℓ, α_eff and only the (N, M) planes dd² and dg² that the inputs asking for
a gradient need; thin products finish the gradients of x, z and of the
gathered embeddings ex, ez (the embedding trains on the MGGP path, so
these flow back through the ``embedding[groups]`` gather).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gpzoo_tpu_torch.ops import _build
from gpzoo_tpu_torch.ops.distance import squared_dist

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mggp_gram_f32": ([_P] * 8 + [_I] * 5 + [ctypes.c_float, _P], _I),
    "mggp_gram_bwd_f32": ([_P] * 12 + [_I] * 5 + [ctypes.c_float, _P], _I),
    "mggp_gram_bwd_blocks": ([_I] * 5, ctypes.c_longlong),
}
_REFUSED = 1  # cudaErrorInvalidValue: the entry point does not take the shape


def mggp_gram_plain(x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
    """(L, N, M) σ_l² exp(−½ d²/ℓ_l²/(α_l g² + 1)) (α_l g² + 1)^(−p/2) from
    the expanded, clamped squared distances d² (x, z) and g² (ex, ez);
    sigma, lengthscale, alpha_eff are (L,), p = ``input_dim``."""
    d2 = squared_dist(x, z)
    g2 = squared_dist(ex, ez)
    denom = alpha_eff[:, None, None] * g2 + 1.0
    return (torch.square(sigma)[:, None, None]
            * torch.exp(-0.5 * d2 / torch.square(lengthscale)[:, None, None] / denom)
            * denom ** (-0.5 * input_dim))


def _expanded(a, b):
    """The clamped expanded squared distance of :func:`squared_dist` and the
    clamp's gradient: 1 above 0, ½ at it (``jnp.maximum``'s tie), 0 below."""
    r2 = (torch.sum(torch.square(a), dim=-1, keepdim=True) - 2.0 * (a @ b.T)
          + torch.sum(torch.square(b), dim=-1)[None, :])
    slope = (r2 > 0).to(r2.dtype) + 0.5 * (r2 == 0).to(r2.dtype)
    return torch.clamp_min(r2, 0.0), slope


def _from_plane(a, b, w, need_a, need_b):
    """The gradients of a and b from w = d(loss)/d‖a_n − b_m‖² (N, M):
    2(a·rowsum(w) − w b) and 2(b·colsum(w) − wᵀa), a reduction and a
    product as JAX's vjp of the expanded distance forms them (the closed
    form's finish, held to JAX's trajectories at 1e-8)."""
    da = 2.0 * (a * w.sum(dim=1, keepdim=True) - w @ b) if need_a else None
    db = 2.0 * (b * w.sum(dim=0)[:, None] - w.T @ a) if need_b else None
    return da, db


def _from_plane_fused(a, b, w, need_a, need_b):
    """:func:`_from_plane` with each sum and its product from one pass over
    w (b and a widened by a column of ones): the backward kernel's finish
    on the card. The two orders differ in the last bits; the card's step
    checks against float64 were set on this one, the CPU trajectories held
    to JAX at 1e-8 on :func:`_from_plane`'s (``chip_smoke.py`` times both)."""
    da = db = None
    if need_a:
        wb = w @ torch.cat([b, torch.ones_like(b[:, :1])], dim=1)
        da = 2.0 * (a * wb[:, -1:] - wb[:, :-1])
    if need_b:
        wa = w.T @ torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
        db = 2.0 * (b * wa[:, -1:] - wa[:, :-1])
    return da, db


def mggp_gram_bwd_plain(g, x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim,
                        needs=(True,) * 7):
    """The gradients (dx, dz, dex, dez, dσ, dℓ, dα) of
    ``sum(g · mggp_gram_plain(...))`` in closed form, None where ``needs``
    (seven flags, in that order) is false. With c = −½/ℓ², den = α g² + 1,
    u = d²/den, e = exp(c u) den^(−p/2) and t = g σ² e:
    dσ = 2σ Σ g e, dℓ = ℓ⁻³ Σ t u, dα = Σ t g² (−c u − p/2)/den, and the
    planes dg² = Σ_l α t (−c u − p/2)/den and dd² = Σ_l c t/den, through
    the clamps' gradient into x, z and ex, ez."""
    need_x, need_z, need_ex, need_ez, need_s, need_l, need_a = needs
    d2, slope_d = _expanded(x, z)
    g2, slope_g = _expanded(ex, ez)
    half_p = 0.5 * input_dim
    c = (-0.5 / torch.square(lengthscale))[:, None, None]
    den = alpha_eff[:, None, None] * g2 + 1.0
    inv = 1.0 / den
    u = d2 * inv
    e = torch.exp(c * u) * den ** (-half_p)
    ge = g * e
    t = torch.square(sigma)[:, None, None] * ge
    ti = t * inv
    q = ti * (-c * u - half_p)
    d_sigma = 2.0 * sigma * ge.sum(dim=(1, 2)) if need_s else None
    d_ell = (t * u).sum(dim=(1, 2)) / lengthscale ** 3 if need_l else None
    d_alpha = (q * g2).sum(dim=(1, 2)) if need_a else None
    dx = dz = dex = dez = None
    if need_x or need_z:
        dx, dz = _from_plane(x, z, (ti * c).sum(dim=0) * slope_d, need_x, need_z)
    if need_ex or need_ez:
        dex, dez = _from_plane(ex, ez, (q * alpha_eff[:, None, None]).sum(dim=0) * slope_g,
                               need_ex, need_ez)
    return dx, dz, dex, dez, d_sigma, d_ell, d_alpha


def _check(x, z, ex, ez, sigma, lengthscale, alpha_eff):
    if x.ndim != 2 or z.ndim != 2 or x.shape[1] != z.shape[1]:
        raise ValueError(f"x (N, D) and z (M, D) expected, got "
                         f"{tuple(x.shape)} and {tuple(z.shape)}")
    if (ex.ndim != 2 or ez.ndim != 2 or ex.shape[1] != ez.shape[1]
            or ex.shape[0] != x.shape[0] or ez.shape[0] != z.shape[0]):
        raise ValueError(f"ex (N, E) and ez (M, E) expected for N={x.shape[0]}, "
                         f"M={z.shape[0]}, got {tuple(ex.shape)} and {tuple(ez.shape)}")
    if sigma.ndim != 1 or sigma.shape != lengthscale.shape or sigma.shape != alpha_eff.shape:
        raise ValueError("sigma, lengthscale and alpha_eff must all be (L,)")


@functools.cache
def _entry(name):
    fn = getattr(_build.library("mggp"), name)
    fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def _raise_for(status, what, shape):
    if status == _REFUSED:
        raise ValueError(f"{what}: unsupported shape " + ", ".join(
            f"{k}={v}" for k, v in zip("NMDEL", shape)))
    _build.check(status, what)


def mggp_gram_fwd(x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
    """(L, N, M) MGGP Gram: kernel 4 on CUDA, :func:`mggp_gram_plain` on
    CPU. x (N, D), z (M, D) with D ≤ 8; ex (N, E), ez (M, E), any E;
    sigma, lengthscale, alpha_eff (L,) with α's convention applied, L ≤
    2,048 on CUDA."""
    _check(x, z, ex, ez, sigma, lengthscale, alpha_eff)
    if x.device.type == "cpu":
        return mggp_gram_plain(x, z, ex, ez, sigma, lengthscale, alpha_eff,
                               input_dim)
    _build.check_operands("mggp_gram", x=x, z=z, ex=ex, ez=ez, sigma=sigma,
                          lengthscale=lengthscale, alpha_eff=alpha_eff)
    shape = (x.shape[0], z.shape[0], x.shape[1], ex.shape[1], sigma.shape[0])
    out = torch.empty((shape[4], shape[0], shape[1]), dtype=x.dtype, device=x.device)
    status = _entry("mggp_gram_f32")(
        x.data_ptr(), z.data_ptr(), ex.data_ptr(), ez.data_ptr(), sigma.data_ptr(),
        lengthscale.data_ptr(), alpha_eff.data_ptr(), out.data_ptr(), *shape,
        0.5 * input_dim, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_for(status, "mggp_gram_f32", shape)
    mggp_gram_fwd.launches += 1
    return out


mggp_gram_fwd.launches = 0


@functools.lru_cache(maxsize=64)
def _bwd_blocks(shape):
    return _entry("mggp_gram_bwd_blocks")(*shape)


def mggp_gram_bwd_planes(g, x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim,
                         needs=(True,) * 7):
    """The backward kernel's outputs for CUDA tensors, launched once (counted
    in ``mggp_gram_bwd.launches``): the planes dd² and dg² (N, M), each only
    where x or z (ex or ez) needs a gradient, and (dσ, dℓ, dα) stacked (3,
    L) where one of them does; None for what is not written. g must be
    contiguous."""
    _build.check_operands("mggp_gram_bwd", g=g, x=x, z=z, ex=ex, ez=ez, sigma=sigma,
                          lengthscale=lengthscale, alpha_eff=alpha_eff)
    need_x, need_z, need_ex, need_ez, *need_h = needs
    shape = (x.shape[0], z.shape[0], x.shape[1], ex.shape[1], sigma.shape[0])
    blocks = _bwd_blocks(shape)
    if blocks < 0:
        _raise_for(_REFUSED, "mggp_gram_bwd_f32", shape)

    def empty(*size):
        return torch.empty(size, dtype=g.dtype, device=g.device)

    dd2 = empty(shape[0], shape[1]) if need_x or need_z else None
    dg2 = empty(shape[0], shape[1]) if need_ex or need_ez else None
    hyper = empty(3, shape[4]) if any(need_h) else None
    partials = empty(3, shape[4], blocks) if hyper is not None else None
    status = _entry("mggp_gram_bwd_f32")(
        g.data_ptr(), x.data_ptr(), z.data_ptr(), ex.data_ptr(), ez.data_ptr(),
        sigma.data_ptr(), lengthscale.data_ptr(), alpha_eff.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (dd2, dg2, hyper, partials)),
        *shape, 0.5 * input_dim, torch.cuda.current_stream(g.device).cuda_stream)
    _raise_for(status, "mggp_gram_bwd_f32", shape)
    mggp_gram_bwd.launches += 1
    return dd2, dg2, hyper


def mggp_gram_bwd(g, x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim,
                  needs=(True,) * 7):
    """(dx, dz, dex, dez, dσ, dℓ, dα) for the cotangent g (L, N, M), None
    where ``needs`` is false: the backward kernel on CUDA
    (:func:`mggp_gram_bwd_planes`, then :func:`grads_from_planes`; a g that
    is not contiguous is copied first, counted in ``copies``),
    :func:`mggp_gram_bwd_plain` on CPU."""
    _check(x, z, ex, ez, sigma, lengthscale, alpha_eff)
    if g.shape != (sigma.shape[0], x.shape[0], z.shape[0]):
        raise ValueError(f"g must be (L, N, M) = {(sigma.shape[0], x.shape[0], z.shape[0])}, "
                         f"got {tuple(g.shape)}")
    if x.device.type == "cpu":
        return mggp_gram_bwd_plain(g, x, z, ex, ez, sigma, lengthscale, alpha_eff,
                                   input_dim, needs)
    if not g.is_contiguous():
        g = g.contiguous()
        mggp_gram_bwd.copies += 1
    planes = mggp_gram_bwd_planes(g, x, z, ex, ez, sigma, lengthscale, alpha_eff,
                                  input_dim, needs)
    return grads_from_planes(x, z, ex, ez, *planes, needs)


mggp_gram_bwd.launches = 0
mggp_gram_bwd.copies = 0


def grads_from_planes(x, z, ex, ez, dd2, dg2, hyper, needs):
    """The seven gradients from the backward kernel's outputs: the planes
    dd² and dg² (N, M) (None where not written) and hyper (3, L) = (dσ, dℓ,
    dα) (None where not written)."""
    need_x, need_z, need_ex, need_ez, need_s, need_l, need_a = needs
    dx, dz = (_from_plane_fused(x, z, dd2, need_x, need_z) if dd2 is not None
              else (None, None))
    dex, dez = (_from_plane_fused(ex, ez, dg2, need_ex, need_ez) if dg2 is not None
                else (None, None))
    hyper = (None,) * 3 if hyper is None else hyper.unbind(0)
    return (dx, dz, dex, dez, *(h if need else None
                                for h, need in zip(hyper, (need_s, need_l, need_a))))


class MGGPGram(torch.autograd.Function):
    """Differentiable MGGP Gram; the backward is :func:`mggp_gram_bwd`
    (no d², g² or (L, N, M) tensor is kept from the forward)."""

    @staticmethod
    def forward(ctx, x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
        ctx.input_dim = input_dim
        ctx.save_for_backward(x, z, ex, ez, sigma, lengthscale, alpha_eff)
        return mggp_gram_fwd(x, z, ex, ez, sigma, lengthscale, alpha_eff,
                             input_dim)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:7]
        if not any(needs):
            return (None,) * 8
        return (*mggp_gram_bwd(g, *ctx.saved_tensors, ctx.input_dim, needs), None)


def mggp_gram(x, z, ex, ez, sigma, lengthscale, alpha_eff, input_dim):
    """Differentiable (L, N, M) MGGP Gram; sigma, lengthscale, alpha_eff
    (L,)."""
    return MGGPGram.apply(x, z, ex, ez, sigma, lengthscale, alpha_eff,
                          input_dim)
