"""Kernel 5's backward (``vnngp_cuda.block_conditional_bwd``) against the
JAX package, on CPU in float64.

The closed form ``block_conditional_bwd_plain`` is the CPU route of
``BlockConditional.backward`` and the card's reference for
``csrc/vnngp.cu`` ``block_conditional_bwd_f32``; it is held against
``jax.vjp`` of ``vnngp_pallas._xla_reference`` (JAX's ``_bwd``) at 1e-10,
with an s that is not symmetric, every subset of the wanted gradients,
K from 1 to 16 and ragged n. The kernel itself runs only on the card
(chip_smoke.py); here its wrapper's guards are checked on ``meta`` tensors.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpzoo_tpu as gz
from gpzoo_tpu.ops import vnngp_pallas
from gpzoo_tpu.train.fast_vnngp import vnngp_nsf_negative_elbo_batched as j_batched
from gpzoo_tpu.train.loop import _path_str

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.convert import vnngp_from_numpy
from gpzoo_tpu_torch.ops import vnngp_cuda

T = torch.tensor
JITTER = 1e-2
LEAVES = ("kzz", "s", "kxz", "mu", "kxx")


def _close(got, expect, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    np.testing.assert_allclose(got, expect, rtol=0,
                               atol=rtol * max(np.max(np.abs(expect)), 1e-300))


def _operands(seed, n, k):
    """SPD kzz blocks, an s that is not symmetric (the gathered s = lu luᵀ
    is not bit-symmetric; here it is off by far more), kxz, mu, kxx and
    both cotangents."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k, k))
    kzz = a @ np.swapaxes(a, -1, -2) + 3 * np.eye(k)
    b = rng.standard_normal((n, k, k)) * 0.3
    s = b @ np.swapaxes(b, -1, -2) + 0.1 * rng.standard_normal((n, k, k))
    return (kzz, s, rng.standard_normal((n, k)), rng.standard_normal((n, k)),
            rng.uniform(0.5, 2.0, n)), (rng.standard_normal(n), rng.standard_normal(n))


def _jax_vjp(ops, cot):
    _, vjp = jax.vjp(lambda *a: vnngp_pallas._xla_reference(*a, jitter=JITTER),
                     *map(jnp.asarray, ops))
    return vjp(tuple(map(jnp.asarray, cot)))


@pytest.mark.parametrize("n", [1, 33, 70])
@pytest.mark.parametrize("k", [1, 2, 8, 16])
def test_closed_form_matches_jax_vjp(k, n):
    ops, cot = _operands(10 * k + n, n, k)
    assert k == 1 or not np.allclose(ops[1], np.swapaxes(ops[1], -1, -2))
    got = vnngp_cuda.block_conditional_bwd_plain(*map(T, ops[:4]), *map(T, cot), JITTER)
    for name, g, e in zip(LEAVES, got, _jax_vjp(ops, cot)):
        _close(g, e, 1e-10)


@pytest.mark.parametrize("needs", list(itertools.product((False, True), repeat=5)),
                         ids=lambda f: "".join("x" if v else "-" for v in f))
def test_closed_form_computes_only_what_is_asked(needs):
    ops, cot = _operands(3, 37, 5)
    got = vnngp_cuda.block_conditional_bwd(*map(T, ops[:4]), *map(T, cot), JITTER, needs)
    expect = _jax_vjp(ops, cot)
    for need, g, e in zip(needs, got, expect):
        if need:
            _close(g, e, 1e-10)
        else:
            assert g is None


def test_block_conditional_backward_takes_the_closed_form(monkeypatch):
    """autograd through ``block_conditional`` on CPU tensors calls
    ``block_conditional_bwd_plain`` once, asks it for the leaves that need
    a gradient only, and matches JAX's custom VJP through the interpreted
    Pallas forward."""
    ops, cot = _operands(5, 40, 3)
    calls = []
    plain = vnngp_cuda.block_conditional_bwd_plain

    def spy(*args):
        calls.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(vnngp_cuda, "block_conditional_bwd_plain", spy)
    ts = [T(v, requires_grad=name != "s") for name, v in zip(LEAVES, ops)]
    m, c = vnngp_cuda.block_conditional(*ts, JITTER)
    (torch.sum(m * T(cot[0])) + torch.sum(c * T(cot[1]))).backward()
    assert calls == [(True, False, True, True, True)]

    def f_jax(*a):
        jm, jc = vnngp_pallas.block_conditional(*a, JITTER, True)
        return jnp.sum(jm * cot[0]) + jnp.sum(jc * cot[1])

    expect = jax.grad(f_jax, tuple(range(5)))(*map(jnp.asarray, ops))
    for t, e in zip(ts, expect):
        if t.requires_grad:
            _close(t.grad, e, 1e-10)
    assert ts[1].grad is None


def test_wrapper_guards_refuse_before_any_launch():
    """Off the CPU a tensor goes to the kernel or raises: on ``meta`` every
    malformed or kernel-less call raises and the counter does not move."""
    ops, cot = _operands(6, 10, 4)
    meta = [T(v, dtype=torch.float32).to("meta") for v in ops[:4] + cot]
    before = vnngp_cuda.block_conditional_bwd.launches
    with pytest.raises(ValueError):  # no kernel for meta
        vnngp_cuda.block_conditional_bwd(*meta, JITTER)
    with pytest.raises(ValueError):  # kxz of another n
        vnngp_cuda.block_conditional_bwd(meta[0], meta[1], meta[2][:5], *meta[3:], JITTER)
    with pytest.raises(ValueError):  # g_mean of another n
        vnngp_cuda.block_conditional_bwd(*meta[:4], meta[4][:3], meta[5], JITTER)
    cpu = [T(v) for v in ops[:4] + cot]
    with pytest.raises(ValueError):  # mixed devices
        vnngp_cuda.block_conditional_bwd(*meta[:4], *cpu[4:], JITTER)
    assert vnngp_cuda.block_conditional_bwd.launches == before
    got = vnngp_cuda.block_conditional_bwd(*cpu, JITTER)  # CPU: the plain form
    assert vnngp_cuda.block_conditional_bwd.launches == before
    assert got[4] is cpu[5]


# --- the VNNGP all-trainable loss through the new CPU backward ------------------

N, D, L, M, K, B = 240, 12, 3, 36, 4, 48


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(shared_kernel):
    return jax.jit(jax.value_and_grad(functools.partial(
        j_batched, E=1, shared_kernel=shared_kernel, y_transposed=True)))


@pytest.mark.parametrize("shared_kernel", [False, True])
def test_all_trainable_loss_gradients_match_jax(monkeypatch, shared_kernel):
    """Every leaf of the VNNGP all-trainable loss (Z, σ, ℓ, mu, Lu, W, V)
    against ``jax.grad`` at 1e-8, with the VNNGP prior's backward going
    through ``block_conditional_bwd_plain``."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, (N, 2))
    y = rng.poisson(3.0, (N, D)).astype(np.float64)
    jmodel = gz.VNNGPConfig(D=D, N=N, L=L, M=M, K=K).build(
        jax.random.PRNGKey(5), X=jnp.asarray(coords))
    gp = jmodel.prior.replace(mu=jnp.asarray(0.3 * rng.standard_normal((M,))),
                              Lu_raw=jnp.asarray(0.2 * rng.standard_normal((M, M))))
    jmodel = jmodel.replace(prior=gp)
    k_idx, k_eps = jax.random.split(jax.random.PRNGKey(9))
    idx = jax.random.choice(k_idx, N, (B,), replace=False)
    eps = jax.random.normal(k_eps, (1, L, B), dtype=jnp.float64)
    jval, jgrad = _j_value_and_grad(shared_kernel)(
        jmodel, jnp.asarray(coords), jnp.asarray(y), idx, k_eps)
    leaves = {_path_str(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jmodel)[0]}
    tmodel = vnngp_from_numpy(leaves, "cpu", torch.float64, K=gp.K, jitter=gp.jitter,
                              var_floor=gp.var_floor)
    calls = []
    plain = vnngp_cuda.block_conditional_bwd_plain

    def spy(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(vnngp_cuda, "block_conditional_bwd_plain", spy)
    tval = gt.vnngp_nsf_negative_elbo_batched(
        tmodel, T(coords), T(y), T(np.asarray(idx)), T(np.asarray(eps)),
        shared_kernel=shared_kernel, y_transposed=True)
    tval.backward()
    assert calls
    _close(tval, jval, 1e-8)
    jg = {_path_str(p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    for path, p in tmodel.named_parameters():
        _close(p.grad, jg[path], 1e-8)
