"""What of kernels 3 and 5 can be checked without a card.

``csrc/gram.cu`` (the RBF Gram) and ``csrc/vnngp.cu`` (the per-point K×K
conditioning) run only on the card, where chip_smoke.py holds each against
its plain version at every path shape and at ragged ones. Here:

* a float32 emulation of kernel 3's order of operations (the direct d²
  and the base-2 exponential with log₂e folded into the scale) agrees with
  the JAX package's Pallas kernel in interpret mode and with the port's
  plain version, at the tolerance chip_smoke.py holds the card to, for
  every coordinate width the kernel is instantiated for and for row
  lengths that are and are not a multiple of its 4-column stores;
* the two wrappers refuse malformed operands on every device, and a
  tensor that is not on the CPU never falls back to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpzoo_tpu.ops import gram_pallas

from gpzoo_tpu_torch.ops import gram_cuda, vnngp_cuda

# chip_smoke.py's tolerance on max|got − ref| / max|ref|: the cancellation
# of the expanded ‖x‖² − 2x·z + ‖z‖² near d = 0 (~4e-6 at |coords| ≤ 2√2)
# and ex2.approx's ~2⁻²² relative error.
TOL_GRAM = 2e-5
NEG_HALF_LOG2E = -0.5 * np.log2(np.e)


def _norm_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# --- kernel 3: the arithmetic ---------------------------------------------------

def _gram_emulation(x, z, sigma, ell):
    """The kernel's order in float32: d² = Σ_d (x_d − z_d)² accumulated over
    d, then σ²·2^(scale·d²) with (σ², scale) from ``rbf_epilogue``."""
    d2 = torch.zeros((x.shape[0], z.shape[0]), dtype=torch.float32)
    for d in range(x.shape[1]):
        diff = x[:, None, d] - z[None, :, d]
        d2 = d2 + diff * diff
    sigma2 = sigma * sigma
    scale = torch.tensor(NEG_HALF_LOG2E, dtype=torch.float32) / (ell * ell)
    return sigma2[:, None, None] * torch.exp2(d2[None] * scale[:, None, None])


@pytest.mark.parametrize("n,m,dim,l_dim", [
    (1, 5, 2, 1), (37, 150, 2, 3), (7, 1025, 1, 2), (64, 96, 3, 1),
    (20, 33, 8, 4), (3, 1023, 4, 10), (11, 130, 5, 1), (1, 66, 6, 2),
    (9, 256, 7, 1)])
def test_gram_emulation_matches_pallas_and_plain(n, m, dim, l_dim):
    rng = np.random.default_rng(n + m + dim)
    x = rng.uniform(-2, 2, (n, dim)).astype(np.float32)
    z = rng.uniform(-2, 2, (m, dim)).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, l_dim).astype(np.float32)
    ell = rng.uniform(0.3, 3.0, l_dim).astype(np.float32)
    got = _gram_emulation(*map(torch.from_numpy, (x, z, sigma, ell)))
    pallas = gram_pallas.rbf_gram(jnp.asarray(x), jnp.asarray(z), jnp.asarray(sigma),
                                  jnp.asarray(ell), True)
    plain = gram_cuda.rbf_gram_plain(*map(torch.from_numpy, (x, z, sigma, ell)))
    assert got.shape == (l_dim, n, m)
    assert _norm_err(got, pallas) <= TOL_GRAM
    assert _norm_err(got, plain) <= TOL_GRAM


# --- the wrappers' operand guards ------------------------------------------------

def _gram_args(device="cpu", dtype=torch.float32, x_shape=(4, 2), z_shape=(6, 2),
               l_dims=(3, 3)):
    return (torch.zeros(x_shape, dtype=dtype, device=device),
            torch.zeros(z_shape, dtype=dtype, device=device),
            torch.ones(l_dims[0], dtype=dtype, device=device),
            torch.ones(l_dims[1], dtype=dtype, device=device))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("bad", [dict(x_shape=(4,)), dict(z_shape=(6, 3)),
                                 dict(z_shape=(2, 6, 2)), dict(l_dims=(3, 2))])
def test_rbf_gram_refuses_malformed_operands(device, bad):
    with pytest.raises(ValueError):
        gram_cuda.rbf_gram_fwd(*_gram_args(device, **bad))


def test_rbf_gram_off_cpu_checks_dtype_and_layout_before_any_kernel():
    """Off the CPU the wrapper goes to the kernel or raises; it never
    converts an operand or falls back to the plain version."""
    with pytest.raises(TypeError):
        gram_cuda.rbf_gram_fwd(*_gram_args("meta", torch.float64))
    x, z, sigma, ell = _gram_args("meta", x_shape=(2, 4))
    with pytest.raises(ValueError, match="contiguous"):
        gram_cuda.rbf_gram_fwd(x.T, z[:, :2].contiguous(), sigma, ell)
    before = gram_cuda.rbf_gram_fwd.launches
    with pytest.raises(ValueError, match="no kernel"):
        gram_cuda.rbf_gram_fwd(*_gram_args("meta"))
    assert gram_cuda.rbf_gram_fwd.launches == before


def _block_args(n=5, k=3, device="cpu", **shapes):
    want = dict(kzz=(n, k, k), s=(n, k, k), kxz=(n, k), mu=(n, k), kxx=(n,))
    want.update(shapes)
    return [torch.zeros(v, device=device) for v in want.values()]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("bad", [dict(kzz=(5, 3, 4)), dict(s=(5, 3, 3, 1)),
                                 dict(kxz=(4, 3)), dict(mu=(5, 2)),
                                 dict(kxx=(5, 1))])
def test_block_conditional_refuses_malformed_operands(device, bad):
    with pytest.raises(ValueError):
        vnngp_cuda.block_conditional_fwd(*_block_args(device=device, **bad), 0.1)


def test_block_conditional_never_falls_back_off_cpu():
    before = vnngp_cuda.block_conditional_fwd.launches
    with pytest.raises(ValueError, match="no kernel"):
        vnngp_cuda.block_conditional_fwd(*_block_args(device="meta"), 0.1)
    assert vnngp_cuda.block_conditional_fwd.launches == before
