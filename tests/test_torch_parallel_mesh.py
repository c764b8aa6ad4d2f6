"""The port's meshes and collectives (``gpzoo_tpu_torch.parallel.mesh``,
``.collectives``) on four gloo ranks on the CPU, in float64.

One spawn of four ranks (tests/_torch_parallel_ranks.py ``scenario_mesh``)
builds the meshes and runs the collectives; the tests read its results.
The gradient check holds a small loss of the losses' shape (a per-factor
leaf gathered over the factor axis, a loading after the gather, a KL summed
over the factors, the minibatch split over the data axis) against the same
loss unsharded: a backward of the gather that summed over the factor ranks
(as ``torch.distributed.nn.functional.all_gather``'s does) would give twice
the per-factor gradient, and a data sum that did not scale its backward
half the data term's.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import spawn

from gpzoo_tpu_torch.parallel import initialize_distributed


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("mesh", 4, tmp_path_factory.mktemp("mesh"), {})


def test_create_mesh_shapes(ranks):
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo"
        assert out["shape"] == {"data": 2, "factor": 2}
        assert out["coords"] == {"data": r // 2, "factor": r % 2}
        assert out["inferred"] == {"data": 2, "factor": 2}
        assert out["dp"] == {"data": 4}


def test_create_mesh_refusals(ranks):
    """Sizes that do not multiply to the world, two inferred sizes, and
    dcn/ici names that overlap raise ValueError."""
    for out in ranks:
        assert out["refused"] == [True, True, True, True]


def test_hybrid_mesh_rank_grouping(ranks):
    """DCN axes first, each contiguous pair of ranks one host
    (LOCAL_WORLD_SIZE=2); an ICI product other than the host's ranks is
    refused; the product of two axes is one group in row-major order."""
    for r, out in enumerate(ranks):
        assert out["hybrid_ranks"] == [[0, 1], [2, 3]]
        assert out["hybrid_local_refused"]
        assert out["product"] == (4, r, 4)
        assert out["product_sum"] == 10.0


def _unsharded():
    g = torch.Generator().manual_seed(0)
    mu = torch.randn(4, generator=g, dtype=torch.float64).requires_grad_(True)
    w = torch.rand((3, 4), generator=g, dtype=torch.float64).requires_grad_(True)
    z = torch.randn((4, 6), generator=g, dtype=torch.float64)
    c = torch.rand(6, generator=g, dtype=torch.float64)
    loss = -(torch.sum(c * (w @ torch.exp(mu[:, None] + z))) - torch.sum(mu ** 2))
    loss.backward()
    return float(loss.detach()), mu.detach().numpy(), mu.grad.numpy(), w.grad.numpy()


def test_collective_gradients_match_unsharded(ranks):
    loss, mu, dmu, dw = _unsharded()
    for out in ranks:
        fi = out["coords"]["factor"]
        assert out["loss"] == pytest.approx(loss, rel=1e-13)
        np.testing.assert_allclose(out["dmu"], dmu[2 * fi:2 * fi + 2], rtol=1e-13)
        np.testing.assert_allclose(out["dw"], dw, rtol=1e-13)
    # the trap: a gather whose backward summed over the two factor ranks
    # would double the data term's share of dmu (dmu − 2μ); the check above
    # tells the two apart
    trapped = 2 * (dmu - 2 * mu) + 2 * mu
    assert np.max(np.abs(trapped - dmu)) > 1e-3 * np.max(np.abs(dmu))


def test_column_gather_replicate_and_blocks(ranks):
    for r, out in enumerate(ranks):
        got, expect, same_shape = out["take"]
        np.testing.assert_array_equal(got, expect)
        assert same_shape
        np.testing.assert_array_equal(out["replicated"], [0.0, 0.0])
        fi = out["coords"]["factor"]
        np.testing.assert_array_equal(out["block"], np.arange(8.0)[4 * fi:4 * fi + 4])
        assert out["bytes"] > 0


@pytest.mark.parametrize("device_type,backend", [("cuda", "nccl"), ("cpu", "gloo")])
def test_initialize_distributed_default_backend(device_type, backend):
    """NCCL on the card unless the caller asks for gloo or the CPU."""
    with mock.patch("torch.distributed.init_process_group") as init:
        initialize_distributed(device_type=device_type, rank=0, world_size=1)
        initialize_distributed(backend="gloo", device_type=device_type)
    assert init.call_args_list[0].args == (backend,)
    assert init.call_args_list[1].args == ("gloo",)
    with pytest.raises(ValueError):
        initialize_distributed(device_type="tpu")
