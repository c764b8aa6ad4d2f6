"""The port's ops and plain kernel forms against the JAX package, on CPU.

Inputs are numpy arrays from a seed, fed to both packages; float64 unless
a JAX Pallas kernel (interpret mode) computes in float32/bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpzoo_tpu import bijectors as jbij
from gpzoo_tpu import dists as jdists
from gpzoo_tpu.data.metrics import poisson_deviance as jdeviance
from gpzoo_tpu.kernels import RBF as JRBF
from gpzoo_tpu.ops import distance as jdist
from gpzoo_tpu.ops import gram_pallas, tri_pallas
from gpzoo_tpu.ops import linalg as jlinalg
from gpzoo_tpu.ops import tri_blocked as jtri

from gpzoo_tpu_torch import bijectors, dists
from gpzoo_tpu_torch.data.metrics import poisson_deviance
from gpzoo_tpu_torch.ops import distance, gram_cuda, linalg, tri_blocked, tri_cuda

T = torch.tensor


def _close(got, expect, rtol):
    """Max-normalized comparison: |got − expect| ≤ rtol · max|expect|."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _tri_operands(rng, L, M, B, dtype=np.float64):
    lu = (np.tril(rng.standard_normal((L, M, M))) / np.sqrt(M)).astype(dtype)
    a = rng.standard_normal((M, B)).astype(dtype)
    return lu, a


# --- bijectors, distance, linalg, dists ------------------------------------

def test_softplus_and_inverse(rng):
    x = rng.standard_normal(200) * 30
    _close(bijectors.softplus(T(x)), jbij.softplus(jnp.asarray(x)), 1e-14)
    y = np.abs(x) + 1e-3
    _close(bijectors.softplus_inverse(T(y)),
           jbij.softplus_inverse(jnp.asarray(y)), 1e-13)


def test_lower_cholesky_and_inverse(rng):
    raw = rng.standard_normal((3, 7, 7))
    lu = bijectors.lower_cholesky(T(raw))
    _close(lu, jbij.lower_cholesky(jnp.asarray(raw)), 1e-15)
    _close(bijectors.lower_cholesky_inverse(lu),
           jbij.lower_cholesky_inverse(jnp.asarray(np.asarray(lu))), 1e-14)


def test_lower_cholesky_gradient(rng):
    raw = rng.standard_normal((2, 6, 6))
    g = rng.standard_normal((2, 6, 6))
    raw_t = T(raw, requires_grad=True)
    torch.sum(bijectors.lower_cholesky(raw_t) * T(g)).backward()
    expect = jax.grad(lambda r: jnp.sum(jbij.lower_cholesky(r) * g))(
        jnp.asarray(raw))
    _close(raw_t.grad, expect, 1e-14)


def test_squared_dist(rng):
    x, z = rng.standard_normal((30, 2)), rng.standard_normal((20, 2))
    _close(distance.squared_dist(T(x), T(z)),
           jdist.squared_dist(jnp.asarray(x), jnp.asarray(z)), 1e-13)
    # clamped at 0 for coincident points
    assert float(distance.squared_dist(T(x), T(x)).min()) >= 0.0


def test_linalg_jitter_logdet_inverse(rng):
    a = rng.standard_normal((3, 9, 9))
    k = a @ np.swapaxes(a, -1, -2) + 9 * np.eye(9)
    _close(linalg.add_jitter(T(k), 0.1),
           jlinalg.add_jitter(jnp.asarray(k), 0.1), 1e-15)
    lz = np.linalg.cholesky(k)
    _close(linalg.tril_logdet(T(lz)), jlinalg.tril_logdet(jnp.asarray(lz)),
           1e-14)
    _close(linalg.spd_inverse_from_cholesky(T(lz)),
           jlinalg.spd_inverse_from_cholesky(jnp.asarray(lz)), 1e-10)


def test_sqrt_safe_grad_zero_gradient_at_zero():
    x = T([0.0, 0.25, 4.0, 0.0], requires_grad=True)
    y = linalg.sqrt_safe_grad(x)
    np.testing.assert_array_equal(y.detach().numpy(), [0.0, 0.5, 2.0, 0.0])
    y.sum().backward()
    expect = jax.grad(lambda v: jnp.sum(jlinalg.sqrt_safe_grad(v)))(
        jnp.asarray([0.0, 0.25, 4.0, 0.0]))
    assert np.all(np.isfinite(x.grad.numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(expect), rtol=1e-15)
    assert x.grad[0] == 0.0 and x.grad[3] == 0.0


def test_poisson_unnormalized_log_prob(rng):
    rate = np.concatenate([[0.0, 0.0], rng.uniform(0.1, 5.0, 50)])
    y = np.concatenate([[0.0, 3.0], rng.poisson(2.0, 50).astype(float)])
    got = dists.Poisson(T(rate)).unnormalized_log_prob(T(y))
    expect = jdists.Poisson(jnp.asarray(rate)).unnormalized_log_prob(
        jnp.asarray(y))
    assert float(got[0]) == 0.0  # the y = rate = 0 limit
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(expect)[1:],
                               rtol=1e-14)


def test_poisson_deviance(rng):
    y = rng.poisson(2.0, (20, 30)).astype(float)
    rate = rng.uniform(0.5, 4.0, (20, 30))
    _close(poisson_deviance(T(y), T(rate)), jdeviance(y, rate), 1e-14)


# --- triangular contractions: plain forms against tri_blocked --------------

@pytest.mark.parametrize("M", [130, 1100])
def test_tri_plain_forms_match_tri_blocked(rng, M):
    """M=130 runs as one panel, M=1100 (≥ MIN_DIM) as six."""
    lu, a = _tri_operands(rng, 2, M, 9)
    k = rng.standard_normal((M, M))
    k_inv = k @ k.T / M
    _close(tri_blocked.tri_sq_colsum(T(lu), T(a)),
           jtri.tri_sq_colsum(jnp.asarray(lu), jnp.asarray(a)), 1e-10)
    _close(tri_blocked.tri_t_matmul(T(lu), T(a)),
           jtri.tri_t_matmul_b(jnp.asarray(lu), jnp.asarray(a)), 1e-10)
    _close(tri_blocked.tri_kl_trace(T(k_inv), T(lu)),
           jtri.tri_kl_trace(jnp.asarray(k_inv), jnp.asarray(lu)), 1e-10)


@pytest.mark.parametrize("M", [130, 1100])
def test_tri_wrappers_on_cpu_take_plain_form(rng, M):
    lu, a = _tri_operands(rng, 2, M, 9)
    before = (tri_cuda.tri_sq_colsum_fused.launches, tri_cuda.tri_t_matmul.launches)
    _close(tri_cuda.tri_sq_colsum_fused(T(lu), T(a)),
           jtri.tri_sq_colsum(jnp.asarray(lu), jnp.asarray(a)), 1e-10)
    _close(tri_cuda.tri_t_matmul(T(lu), T(a)),
           jnp.einsum("lkm,kb->lmb", jnp.asarray(lu), jnp.asarray(a)), 1e-10)
    assert (tri_cuda.tri_sq_colsum_fused.launches,
            tri_cuda.tri_t_matmul.launches) == before


def test_tri_against_pallas_interpret(rng):
    """Same ops against the TPU kernels in interpret mode (bf16 operands,
    f32 accumulation — the tolerance of tests/test_pallas.py)."""
    lu, a = _tri_operands(rng, 2, 200, 260, np.float32)
    got_c = tri_cuda.tri_t_matmul(T(lu), T(a))
    pal_c = tri_pallas.tri_t_matmul(jnp.asarray(lu), jnp.asarray(a), True,
                                    128, 128, 128)
    _close(got_c, pal_c, 5e-3)
    got_s = tri_cuda.tri_sq_colsum_fused(T(lu), T(a))
    pal_s = tri_pallas.tri_sq_colsum_fused(jnp.asarray(lu), jnp.asarray(a),
                                           True, 128, 128, 128)
    _close(got_s, pal_s, 5e-3)


@pytest.mark.parametrize("M", [130, 1100])
def test_tri_sq_colsum_function_gradients(rng, M):
    """TriSqColsum's backward (c recomputed, dc = 2c·g, dLu = tril(a dcᵀ),
    da = Σ Lu dc) against jax.grad through tri_sq_colsum(tril(lu), a)."""
    L, B = 2, 11
    lu = rng.standard_normal((L, M, M)) / np.sqrt(M)  # dense: tril inside
    a = rng.standard_normal((M, B))
    g = rng.standard_normal((L, B))
    lu_t, a_t = T(lu, requires_grad=True), T(a, requires_grad=True)
    out = tri_cuda.tri_sq_colsum(torch.tril(lu_t), a_t)
    out.backward(T(g))
    f = lambda l_, a_: jnp.sum(jtri.tri_sq_colsum(jnp.tril(l_), a_) * g)
    val, (dlu, da) = jax.value_and_grad(f, (0, 1))(jnp.asarray(lu), jnp.asarray(a))
    _close(torch.sum(out * T(g)), val, 1e-10)
    _close(lu_t.grad, dlu, 1e-10)
    _close(a_t.grad, da, 1e-10)


def test_tri_sq_colsum_function_skips_dead_da(rng):
    lu, a = _tri_operands(rng, 2, 40, 7)
    lu_t = T(lu, requires_grad=True)
    a_t = T(a)
    tri_cuda.tri_sq_colsum(lu_t, a_t).sum().backward()
    assert lu_t.grad is not None and a_t.grad is None


@pytest.mark.parametrize("shape", [((2, 5, 5), (4, 3)), ((5, 5), (5, 3))])
def test_tri_wrappers_reject_bad_shapes(shape):
    lu, a = torch.zeros(shape[0]), torch.zeros(shape[1])
    with pytest.raises(ValueError):
        tri_cuda.tri_sq_colsum_fused(lu, a)
    with pytest.raises(ValueError):
        tri_cuda.tri_t_matmul(lu, a)


def test_kernel_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: on a
    device with no kernel (meta) every wrapper raises."""
    lu = torch.zeros((2, 5, 5), device="meta")
    a = torch.zeros((5, 3), device="meta")
    with pytest.raises(ValueError):
        tri_cuda.tri_sq_colsum_fused(lu, a)
    with pytest.raises(ValueError):
        tri_cuda.tri_t_matmul(lu, a)
    x = torch.zeros((4, 2), device="meta")
    s = torch.ones(1, device="meta")
    with pytest.raises(ValueError):
        gram_cuda.rbf_gram_fwd(x, x, s, s)


# --- RBF Gram ---------------------------------------------------------------

def _gram_operands(rng, dtype=np.float64):
    x = rng.uniform(-2, 2, (37, 2)).astype(dtype)
    z = rng.uniform(-2, 2, (23, 2)).astype(dtype)
    sigma = np.asarray([0.7, 1.0, 1.6], dtype)
    ell = np.asarray([0.4, 1.0, 2.5], dtype)
    return x, z, sigma, ell


def test_rbf_gram_plain_matches_jax_rbf(rng):
    x, z, sigma, ell = _gram_operands(rng)
    got = gram_cuda.rbf_gram(T(x), T(z), T(sigma), T(ell))
    expect = JRBF(sigma=jnp.asarray(sigma), lengthscale=jnp.asarray(ell)).gram(
        jnp.asarray(x), jnp.asarray(z))
    assert got.shape == (3, 37, 23)
    _close(got, expect, 1e-13)


def test_rbf_gram_plain_matches_pallas_interpret(rng):
    x, z, sigma, ell = _gram_operands(rng, np.float32)
    got = gram_cuda.rbf_gram(T(x), T(z), T(sigma), T(ell))
    expect = gram_pallas.rbf_gram(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(sigma), jnp.asarray(ell), True)
    # float32: the Pallas kernel forms d² directly, the plain form expands it
    _close(got, expect, 2e-5)


def test_rbf_gram_closed_form_gradients(rng):
    x, z, sigma, ell = _gram_operands(rng)
    g = rng.standard_normal((3, 37, 23))
    ts = [T(v, requires_grad=True) for v in (x, z, sigma, ell)]
    torch.sum(gram_cuda.rbf_gram(*ts) * T(g)).backward()

    def f(x_, z_, s_, l_):
        return jnp.sum(JRBF(sigma=s_, lengthscale=l_).gram(x_, z_) * g)

    expect = jax.grad(f, (0, 1, 2, 3))(*map(jnp.asarray, (x, z, sigma, ell)))
    for t, e in zip(ts, expect):
        _close(t.grad, e, 1e-10)


def test_rbf_gram_gradients_match_pallas_vjp(rng):
    x, z, sigma, ell = _gram_operands(rng, np.float32)
    g = rng.standard_normal((3, 37, 23)).astype(np.float32)
    ts = [T(v, requires_grad=True) for v in (x, z, sigma, ell)]
    torch.sum(gram_cuda.rbf_gram(*ts) * T(g)).backward()
    f = lambda *a: jnp.sum(gram_pallas.rbf_gram(*a, True) * g)
    expect = jax.grad(f, (0, 1, 2, 3))(*map(jnp.asarray, (x, z, sigma, ell)))
    for t, e in zip(ts, expect):
        _close(t.grad, e, 1e-4)


def test_rbf_module_gram_shapes_and_variance(rng):
    from gpzoo_tpu_torch.kernels import NSFRBF, RBF

    x, z, _, _ = _gram_operands(rng)
    scalar = RBF(T(1.3, dtype=torch.float64), T(0.8, dtype=torch.float64))
    expect = JRBF(sigma=1.3, lengthscale=0.8).gram(jnp.asarray(x), jnp.asarray(z))
    got = scalar.gram(T(x), T(z))
    assert got.shape == (37, 23)
    _close(got, expect, 1e-13)
    assert scalar.variance_vector().shape == ()
    batched = NSFRBF.create(sigma=1.3, lengthscale=0.8, L=4, dtype=torch.float64)
    assert batched.gram(T(x), T(z)).shape == (4, 37, 23)
    assert batched.variance_vector().shape == (4, 1)
    assert batched.diag(T(x)).shape == (4, 37)
    assert batched.batch_shape() == (4,)
