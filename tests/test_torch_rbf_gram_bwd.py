"""Kernel 3's backward (``gram_cuda.rbf_gram_bwd``) against the JAX package,
on CPU.

The closed form ``rbf_gram_bwd_plain`` is the CPU route of
``RBFGram.backward`` and the card's reference for ``csrc/gram.cu``
``rbf_gram_bwd_f32``. It is held against ``gram_pallas._rbf_gram_bwd`` on
the same residual (x, z, σ, ℓ, k) in float64 at 1e-10, and, through
``RBFGram``, against ``jax.vjp`` of the interpreted Pallas ``rbf_gram``
(float32, whose forward rounds k: 1e-4, the tolerance of
tests/test_torch_ops.py), over L ∈ {1, 3}, D ∈ {1, 2, 3} and Kzz = k(Z, Z),
where autograd sums the gradients of x and z into one leaf. The kernel runs
only on the card (chip_smoke.py); here its wrapper's guards are checked on
``meta`` tensors.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpzoo_tpu.ops import gram_pallas

from gpzoo_tpu_torch.ops import gram_cuda

T = torch.tensor
LEAVES = ("x", "z", "sigma", "lengthscale")


def _close(got, expect, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _operands(seed, l_dim, n, m, dim, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, dim))
    z = rng.uniform(-2, 2, (m, dim))
    sigma = np.linspace(0.6, 1.7, l_dim)
    ell = np.linspace(0.4, 2.5, l_dim)
    g = rng.standard_normal((l_dim, n, m))
    return [v.astype(dtype) for v in (x, z, sigma, ell, g)]


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("l_dim", [1, 3])
def test_closed_form_matches_jax_bwd_rule(l_dim, dim):
    """The same residual into both closed forms: JAX's expands d² and clamps
    it, as the port's does."""
    x, z, sigma, ell, g = _operands(10 * l_dim + dim, l_dim, 37, 23, dim)
    k = gram_cuda.rbf_gram_plain(*map(T, (x, z, sigma, ell)))
    got = gram_cuda.rbf_gram_bwd_plain(T(g), *map(T, (x, z, sigma, ell)), k)
    expect = gram_pallas._rbf_gram_bwd(
        False, tuple(map(jnp.asarray, (x, z, sigma, ell, k.numpy()))), jnp.asarray(g))
    for name, a, e in zip(LEAVES, got, expect):
        _close(a, e, 1e-10)


@pytest.mark.parametrize("kzz", [False, True], ids=["Kzx", "Kzz"])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("l_dim", [1, 3])
def test_rbf_gram_gradients_match_pallas_vjp(l_dim, dim, kzz):
    """RBFGram's backward on CPU tensors against jax.vjp of the interpreted
    Pallas rbf_gram in float32; for Kzz one leaf z is both x and z."""
    x, z, sigma, ell, g = _operands(20 + 10 * l_dim + dim, l_dim, 29, 29 if kzz else 31,
                                    dim, np.float32)
    ts = [T(v, requires_grad=True) for v in (x, z, sigma, ell)]
    args = (ts[1], ts[1], ts[2], ts[3]) if kzz else ts
    torch.sum(gram_cuda.rbf_gram(*args) * T(g)).backward()
    if kzz:
        f = lambda z_, s_, l_: jnp.sum(gram_pallas.rbf_gram(z_, z_, s_, l_, True) * g)
        expect = dict(zip(LEAVES[1:], jax.grad(f, (0, 1, 2))(
            *map(jnp.asarray, (z, sigma, ell)))))
    else:
        f = lambda *a: jnp.sum(gram_pallas.rbf_gram(*a, True) * g)
        expect = dict(zip(LEAVES, jax.grad(f, (0, 1, 2, 3))(
            *map(jnp.asarray, (x, z, sigma, ell)))))
    for name, t in zip(LEAVES, ts):
        if name in expect:
            _close(t.grad, expect[name], 1e-4)
    assert (ts[0].grad is None) == kzz


@pytest.mark.parametrize("needs", list(itertools.product((False, True), repeat=4)),
                         ids=lambda f: "".join("x" if v else "-" for v in f))
def test_closed_form_computes_only_what_is_asked(needs):
    x, z, sigma, ell, g = _operands(4, 3, 17, 11, 2)
    ops = list(map(T, (x, z, sigma, ell)))
    k = gram_cuda.rbf_gram_plain(*ops)
    got = gram_cuda.rbf_gram_bwd(T(g), *ops, k, needs)
    full = gram_cuda.rbf_gram_bwd_plain(T(g), *ops, k)
    for need, a, e in zip(needs, got, full):
        if need:
            assert torch.equal(a, e)
        else:
            assert a is None


def test_rbf_gram_backward_takes_the_closed_form(monkeypatch):
    """autograd through rbf_gram on CPU tensors calls rbf_gram_bwd_plain
    once, with the leaves that need a gradient."""
    calls = []
    plain = gram_cuda.rbf_gram_bwd_plain

    def spy(*args):
        calls.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(gram_cuda, "rbf_gram_bwd_plain", spy)
    x, z, sigma, ell, g = _operands(5, 2, 13, 9, 2)
    ts = [T(x), T(z, requires_grad=True), T(sigma), T(ell, requires_grad=True)]
    torch.sum(gram_cuda.rbf_gram(*ts) * T(g)).backward()
    assert calls == [(False, True, False, True)]


def test_wrapper_guards_refuse_before_any_launch():
    """Off the CPU a tensor goes to the kernel or raises: on ``meta`` every
    malformed or kernel-less call raises and the counter does not move."""
    x, z, sigma, ell, g = (T(v).to("meta") for v in _operands(6, 2, 5, 4, 2, np.float32))
    k = torch.empty_like(g)
    before = (gram_cuda.rbf_gram_bwd.launches, gram_cuda.rbf_gram_bwd.copies)
    with pytest.raises(ValueError):  # no kernel for meta
        gram_cuda.rbf_gram_bwd(g, x, z, sigma, ell, k)
    with pytest.raises(ValueError):  # g of another shape
        gram_cuda.rbf_gram_bwd(g[:, :3], x, z, sigma, ell, k)
    with pytest.raises(ValueError):  # k of another shape
        gram_cuda.rbf_gram_bwd(g, x, z, sigma, ell, k[:1])
    with pytest.raises(ValueError):  # z of another width
        gram_cuda.rbf_gram_bwd(g, x, torch.empty((4, 3), device="meta"), sigma, ell, k)
    with pytest.raises(ValueError):  # sigma and lengthscale differ
        gram_cuda.rbf_gram_bwd(g, x, z, sigma, ell[:1], k)
    assert (gram_cuda.rbf_gram_bwd.launches, gram_cuda.rbf_gram_bwd.copies) == before
