"""The port's lower clamps at their bounds against gpzoo_tpu, in float64.

``jnp.maximum`` and ``jnp.clip`` give the gradient ½ to an input exactly
at the bound, where ``torch.clamp`` gives 1. The port's clamps go through
``ops.clip.clip_min``, which takes JAX's ½. Each case builds an exact tie
and holds the gradient against JAX's at 1e-8:

* ``squared_dist`` and the plain RBF Gram at points that coincide up to
  rounding: z = x + 2⁻³⁰ in one coordinate, where the expanded form's d²
  rounds to exactly 0 in both packages (asserted), and the other pairs lie
  so far apart that their Gram entries are exactly 0;
* each variance floor and whitened clamp that a gradient reaches at a
  tie: query points so far from Z that Kzx is exactly 0 leave the
  marginal variance at σ² = 1, and the floor is set to 1;
* the clamps whose tie no gradient reaches (their input is a constant of
  the precompute, or its gradient vanishes there) are checked to go
  through ``clip_min``.

The first twelve cases (the helper, the two coincident-point cases, the
floors and the whitened clamps) fail with ``torch.clamp``'s gradient: they
guard the repair. The six routing cases guard only that each clamp goes
through the helper. Matern32 and kernel 3 with Z a subset of X meet d = 0
too, but no clamp's gradient reaches them there (the safe square root's
gradient is 0 at 0, and kernel 3's backward is closed-form): their
parity test is ``test_torch_elbo.py``'s.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.ops.distance import squared_dist as j_squared_dist
from gpzoo_tpu.train.elbo import negative_elbo as j_negative_elbo
from gpzoo_tpu.train.fast import nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str, _value_and_grad

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch import convert
from gpzoo_tpu_torch.ops import gram_cuda
from gpzoo_tpu_torch.ops.clip import clip_min
from gpzoo_tpu_torch.ops.distance import squared_dist

TOL = 1e-8
T = torch.tensor
DELTA = 2.0 ** -30
#: rows at least 98 apart; with z = x + (DELTA, 0) each pair (n, n) has an
#: expanded d² of exactly 0 (every product and sum below is exact)
TIE_X = np.array([[1.0, 0.0], [2.0, 100.0], [-100.0, 4.0]])
TIE_Z = TIE_X + np.array([DELTA, 0.0])


def jax_leaves(model):
    return {_path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def _close(got, expect, rtol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _leaves(*arrays):
    return [T(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("bound", [0.0, 5e-2, 1.0])
def test_clip_min_gradient_at_the_bound_matches_jax(bound):
    """1 above the bound, ½ at it, 0 below, as jnp.maximum and jnp.clip."""
    x = np.array([bound - 0.5, bound, bound + 0.5])
    for jfn in (lambda a: jnp.maximum(a, bound), lambda a: jnp.clip(a, min=bound)):
        expect = jax.grad(lambda a: jnp.sum(jnp.asarray([1.0, 2.0, 3.0]) * jfn(a)))(
            jnp.asarray(x))
        (t,) = _leaves(x)
        out = clip_min(t, bound)
        torch.sum(T([1.0, 2.0, 3.0]) * out).backward()
        _close(out, jfn(jnp.asarray(x)), 0)
        _close(t.grad, expect, 0)
    assert float(t.grad[1]) == 1.0  # ½ of the cotangent 2


def test_squared_dist_gradient_at_coincident_points_matches_jax():
    """d² of points coincident up to rounding is a tie at 0: the cotangent
    on those entries alone gives each row's whole gradient."""
    cot = np.diag([1.0, 2.0, 3.0])
    jr2 = j_squared_dist(jnp.asarray(TIE_X), jnp.asarray(TIE_Z))
    x, z = _leaves(TIE_X, TIE_Z)
    r2 = squared_dist(x, z)
    assert not np.any(np.diag(np.asarray(jr2))) and not torch.diag(r2).any()
    expect = jax.grad(lambda a, b: jnp.sum(cot * j_squared_dist(a, b)), argnums=(0, 1))(
        jnp.asarray(TIE_X), jnp.asarray(TIE_Z))
    torch.sum(T(cot) * r2).backward()
    assert torch.any(x.grad != 0)
    _close(x.grad, expect[0])
    _close(z.grad, expect[1])


def test_plain_rbf_gram_gradient_at_coincident_points_matches_jax():
    """Kernel 3's plain version (autograd through the expanded d²) with Z on
    X up to rounding, L = 2 factors: the off-diagonal entries are exactly 0,
    so each point's gradient is its tie's."""
    sigma, ell = np.array([1.1, 0.9]), np.array([0.8, 1.2])
    cot = np.random.default_rng(0).standard_normal((2, 3, 3))
    jk = gz.kernels.BatchedRBF(sigma=jnp.asarray(sigma), lengthscale=jnp.asarray(ell))

    def jloss(a, b, s, l_):
        return jnp.sum(cot * jk.replace(sigma=s, lengthscale=l_).gram(a, b))

    expect = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (TIE_X, TIE_Z, sigma,
                                                                       ell)))
    leaves = _leaves(TIE_X, TIE_Z, sigma, ell)
    gram = gram_cuda.rbf_gram_plain(*leaves)
    assert torch.count_nonzero(gram) == 6  # the diagonals only
    torch.sum(T(cot) * gram).backward()
    for leaf, e in zip(leaves, expect):
        _close(leaf.grad, e)


# --- the variance floors and whitened clamps ------------------------------------

N_FAR, D, L, M, E = 6, 5, 2, 8, 2


def _far_case(prior, kernel_shape):
    """A JAX NSF over ``prior`` with σ = 1, ``var_floor`` 1 (σ²) and its
    queries 200 away from Z: Kzx is exactly 0, so each marginal variance is
    σ² = 1, exactly at the floor."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (N_FAR, 2)) + 200.0
    y = rng.poisson(2.0, (D, N_FAR)).astype(np.float64)
    kernel = gz.kernels.NSFRBF(sigma=jnp.ones(kernel_shape),
                               lengthscale=jnp.asarray(rng.uniform(0.8, 1.2, kernel_shape)))
    fields = dict(kernel=kernel, Z=jnp.asarray(rng.uniform(-2, 2, (M, 2))),
                  mu=jnp.asarray(0.5 * rng.standard_normal((L, M))),
                  Lu_raw=jnp.asarray(np.tril(0.2 * rng.standard_normal((L, M, M)))),
                  jitter=1e-1, var_floor=1.0)
    gp = gz.gps.VNNGP(**fields, K=3) if prior == "vnngp" else gz.gps.SVGP(**fields)
    jmodel = gz.models.NSF(prior=gp, W_raw=jnp.asarray(rng.uniform(0, 1, (D, L))),
                           V_raw=jnp.asarray(rng.normal(1.0, 0.2, N_FAR)))
    leaves = jax_leaves(jmodel)
    tmodel = (convert.vnngp_from_numpy(leaves, "cpu", torch.float64, K=3, jitter=1e-1,
                                       var_floor=1.0) if prior == "vnngp" else
              convert.nsf_from_numpy(leaves, "cpu", torch.float64, jitter=1e-1,
                                     var_floor=1.0))
    return jmodel, tmodel, x, y, rng.standard_normal((E, L, N_FAR))


def _compare_grads(jval, jgrad, tval, tmodel):
    _close(tval, jval)
    jg = jax_leaves(jgrad)
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path])
    assert tmodel.prior.kernel.sigma.grad.abs().sum() > 0


@pytest.mark.parametrize("prior", ["svgp", "vnngp"])
def test_prior_variance_floor_tie_matches_jax(prior):
    """The floors of the SVGP posterior (gps/svgp.py, shared by MGGPSVGP)
    and of the VNNGP posterior, through the generic negative_elbo."""
    jmodel, tmodel, x, y, eps = _far_case(prior, (L, 1, 1))
    with mock.patch.object(jax.random, "normal",
                           lambda k, shape, dtype=None: jnp.asarray(eps, dtype)):
        jval, jgrad = _value_and_grad(lambda m: j_negative_elbo(
            m, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0), E=E), jmodel)
    tval = gt.negative_elbo(tmodel, T(x), T(y), T(eps))
    tval.backward()
    _compare_grads(jval, jgrad, tval, tmodel)


@pytest.mark.parametrize("branch", ["w_form", "shared_cholesky", "not_factored"])
def test_blockwise_variance_floor_tie_matches_jax(branch):
    """The blockwise loss's variance floors: the W-form (per-factor kernel,
    factored), the shared-Cholesky K⁻¹ branch (one kernel, factored) and
    the library solves (not factored)."""
    shape = () if branch == "shared_cholesky" else (L, 1, 1)
    jmodel, tmodel, x, y, _ = _far_case("svgp", shape)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (E, L, N_FAR), dtype=jnp.float64))
    kw = dict(E=E, microbatch=N_FAR, factored=branch != "not_factored", remat=False)
    idx = np.arange(N_FAR)
    jval, jgrad = _value_and_grad(lambda m: j_batched(
        m, jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx), key, **kw), jmodel)
    tval = gt.nsf_negative_elbo_batched(tmodel, T(x), T(y), T(idx), T(eps), **kw)
    tval.backward()
    _compare_grads(jval, jgrad, tval, tmodel)


@pytest.mark.parametrize("prior", ["wsvgp", "lowrank"])
def test_whitened_clamp_tie_matches_jax(prior):
    """The whitened posteriors' clamp(Kxx − Σ W², 0) at 0: rows of W whose
    squares sum to Kxx exactly, through each prior's tail."""
    rng = np.random.default_rng(5)
    kxx = np.array([1.0, 2.0, 0.5])
    w = np.array([[0.5, 0.5, 0.5, 0.5], [1.0, 1.0, 0.0, 0.0], [0.5, 0.0, 0.5, 0.0]])
    kernel = gz.kernels.RBF(sigma=jnp.asarray(1.0), lengthscale=jnp.asarray(1.0))
    fields = dict(kernel=kernel, Z=jnp.zeros((4, 2)), mu=jnp.asarray(rng.standard_normal(4)))
    if prior == "wsvgp":
        jgp = gz.gps.WSVGP(**fields, Lu_raw=jnp.asarray(np.tril(
            0.3 * rng.standard_normal((4, 4)))))
    else:
        jgp = gz.gps.LowRankWSVGP(**fields, V=jnp.asarray(0.3 * rng.standard_normal((4, 2))),
                                  d_raw=jnp.asarray(rng.uniform(-1, 1, 4)))
    leaves = {k: T(v) for k, v in jax_leaves(jgp).items()}
    tkernel = gt.RBF(leaves.pop("kernel.sigma"), leaves.pop("kernel.lengthscale"))
    tgp = (gt.WSVGP if prior == "wsvgp" else gt.LowRankWSVGP)(tkernel, **leaves)

    def jloss(g, a, b):
        qf = g._tail(a, b)[0]
        return jnp.sum(qf.scale) + jnp.sum(qf.loc)

    assert not np.any(kxx - np.sum(w ** 2, axis=-1))
    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jgp, jnp.asarray(kxx), jnp.asarray(w))
    tk, tw = _leaves(kxx, w)
    qf = tgp._tail(tk, tw)[0]
    tval = torch.sum(qf.scale) + torch.sum(qf.loc)
    tval.backward()
    _close(tval, jval)
    _close(tk.grad, jgrads[1])
    _close(tw.grad, jgrads[2])
    jg = jax_leaves(jgrads[0])
    for path, p in tgp.named_parameters():
        if p.grad is not None:
            _close(p.grad, jg[path])


def _whitened_nsf(rng, n, far):
    """A small NSF over a WSVGP (queries ``far`` from Z), for the routing
    cases."""
    x = rng.uniform(-1, 1, (n, 2)) + far
    kernel = gt.NSFRBF.create(L=L, dtype=torch.float64)
    gp = gt.WSVGP(kernel, T(rng.uniform(-2, 2, (M, 2))), T(rng.standard_normal((L, M))),
                  T(np.tril(0.2 * rng.standard_normal((L, M, M)))), jitter=1e-1)
    return gt.NSF(gp, T(rng.uniform(0, 1, (D, L))), torch.ones(n, dtype=torch.float64)), T(x)


@pytest.mark.parametrize("site", ["blockwise_whitened_factored",
                                  "blockwise_whitened_not_factored",
                                  "precomputed_whitened", "precomputed", "vnngp_precomputed",
                                  "mds_embedding"])
def test_clamps_no_gradient_reaches_at_a_tie_use_clip_min(site):
    """Clamps whose tie no gradient reaches: the whitened blockwise clamp at
    0 (Kxx − Σa² has a zero gradient where it reaches 0), the precomputed
    losses' floors (their Kxx and a² are constants of the precompute), and
    the MDS embedding's eigenvalues (constants). Each must still go
    through ``clip_min`` with its bound."""
    from gpzoo_tpu_torch.ops import linalg
    from gpzoo_tpu_torch.train import fast, fast_vnngp

    rng = np.random.default_rng(6)
    seen = []

    def spy(t, bound):
        seen.append(bound)
        return clip_min(t, bound)

    module = {"vnngp_precomputed": fast_vnngp, "mds_embedding": linalg}.get(site, fast)
    y = T(rng.poisson(2.0, (D, 10)).astype(np.float64))
    eps = T(rng.standard_normal((1, L, 10)))
    idx = torch.arange(10)
    with mock.patch.object(module, "clip_min", spy):
        if site.startswith("blockwise"):
            model, x = _whitened_nsf(rng, 10, 0.0)
            gt.nsf_negative_elbo_batched(model, x, y, idx, eps, E=1, microbatch=10,
                                         factored=site.endswith("_factored") and
                                         "not" not in site)
            expect = 0.0
        elif site == "precomputed_whitened":
            model, x = _whitened_nsf(rng, 10, 0.0)
            gt.nsf_negative_elbo_precomputed(model, gt.precompute_nsf_projection(model, x),
                                             y, idx, eps)
            expect = 0.0
        elif site == "precomputed":
            model = gt.SlideseqNSFConfig(D=D, N=10, L=L, M=M).build(
                torch.Generator().manual_seed(0), T(rng.uniform(-2, 2, (10, 2))))
            x = model.prior.Z.new_tensor(rng.uniform(-2, 2, (10, 2)))
            gt.nsf_negative_elbo_precomputed(model, gt.precompute_nsf_projection(model, x),
                                             y, idx, eps)
            expect = model.prior.var_floor
        elif site == "vnngp_precomputed":
            x = T(rng.uniform(-2, 2, (10, 2)))
            model = gt.VNNGPConfig(D=D, N=10, L=L, M=M, K=3).build(
                torch.Generator().manual_seed(0), x)
            gt.vnngp_nsf_negative_elbo_precomputed(
                model, gt.precompute_vnngp_conditioning(model, x), y, idx, eps)
            expect = model.prior.var_floor
        else:
            linalg.embed_distance_matrix(1.0 - torch.eye(4, dtype=torch.float64))
            expect = 0.0
    assert expect in seen, seen
