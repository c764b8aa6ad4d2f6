"""Multi-process checkpoints of a factor-sharded state and the 2×2 DP+TP run
that mirrors tests/_distributed_child.py, on four gloo ranks on the CPU in
float64.

The ranks lay ``hybrid_mesh({"hosts": 2}, {"data": 1, "factor": 2})`` over
two "hosts" of two ranks (LOCAL_WORLD_SIZE=2), split the minibatch over
``("hosts", "data")`` and the per-factor state over ``"factor"``, and run
three blockwise steps (factored, microbatch 32), held against the JAX
package's unsharded loss and optax Adam on the same draws. Then they save
a checkpoint (one ``.shard<rank>`` file each), restore it with the state's
placement and into an unsplit template, resume bit-identically, save
through ``AsyncCheckpointer`` and ``CheckpointHook`` (synchronous with more
than one rank; the hook clones each rank's file to ``.latest`` and rotates),
and run two data-parallel steps each of the MGGP and VNNGP fast losses over
the same mesh. The parent process then refuses damaged shard sets.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import _full_template, spawn
from test_torch_parallel_step import (STEPS, TOL, _close, _mggp_vnngp_inputs,
                                      jax_leaves, problem)  # noqa: F401

from gpzoo_tpu_torch.train import restore_checkpoint

L = 4


@pytest.fixture(scope="module")
def run(problem, tmp_path_factory):  # noqa: F811
    ref = dict(problem["ref"])
    mggp, vnngp = _mggp_vnngp_inputs(ref)
    workdir = tmp_path_factory.mktemp("ckpt")
    inputs = dict(problem["inputs"], mggp=mggp, vnngp=vnngp)
    ranks = spawn("checkpoint", 4, workdir, inputs, env={"LOCAL_WORLD_SIZE": "2"})
    return ranks, ref, workdir, inputs


def test_dp_tp_steps_match_jax(run):
    ranks, ref, _, _ = run
    losses, _ = ref["batched"]
    for r, out in enumerate(ranks):
        assert out["coords"] == {"hosts": r // 2, "data": 0, "factor": r % 2}
        assert out["losses"] == pytest.approx(losses, rel=TOL)
        assert out["lu_local"] == (L // 2, 16, 16)
        assert out["lu_moment_local"] == (L // 2, 16, 16)


def test_checkpoint_files_and_restores(run):
    """One file per rank; the restore with the placement gives each rank
    its blocks bit for bit; the restore into an unsplit template gives the
    full state, JAX's after three steps, alike on every rank."""
    ranks, ref, _, _ = run
    _, jmodel = ref["batched"]
    jl = jax_leaves(jmodel)
    for out in ranks:
        assert [f for f in out["files"] if f.startswith("ckpt")] == [
            f"ckpt.shard{r}" for r in range(4)]
        assert out["restored_equal"]
        for path, value in out["full"].items():
            np.testing.assert_array_equal(value, ranks[0]["full"][path])
            _close(value, jl[path])
        assert out["full_moments"][0].shape == (L, 16, 16)


def test_resume_is_bit_identical(run):
    ranks, _, _, _ = run
    for out in ranks:
        live, resumed = out["resume"]
        assert live == resumed
        assert out["resumed_equal"]


def test_async_and_hook_write_shard_sets(run):
    ranks, _, _, _ = run
    step = STEPS + 1  # three steps and the resumed one
    expect = sorted([f"async.shard{r}" for r in range(4)]
                    + [f"run.latest.shard{r}" for r in range(4)]
                    + [f"run.step{step + 1}.shard{r}" for r in range(4)])
    for out in ranks:
        assert out["hook_files"] == expect


def test_mggp_vnngp_over_host_axes_match_jax(run):
    ranks, ref, _, _ = run
    for out in ranks:
        assert out["mggp"]["losses"] == pytest.approx(ref["mggp"][0], rel=TOL)
        assert out["vnngp"]["losses"] == pytest.approx(ref["vnngp"][0], rel=1e-8)


def _copy_set(workdir, src, dst):
    for r in range(4):
        shutil.copyfile(os.path.join(workdir, f"{src}.shard{r}"),
                        os.path.join(workdir, f"{dst}.shard{r}"))
    return os.path.join(workdir, dst)


def test_restore_in_one_process_and_refusals(run):
    """A complete set restores in a process without a group (a stale .tmp
    beside it is ignored); a missing file, a file of another save, and a
    single file beside a shard set are refused."""
    ranks, _, workdir, inputs = run
    good = _copy_set(workdir, "ckpt", "good")
    open(good + ".shard7.tmp", "wb").close()
    state = restore_checkpoint(good, _full_template(inputs))
    for path, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ranks[0]["full"][path])

    missing = _copy_set(workdir, "ckpt", "missing")
    os.remove(missing + ".shard3")
    with pytest.raises(ValueError, match="shard files"):
        restore_checkpoint(missing, _full_template(inputs))

    mixed = _copy_set(workdir, "ckpt", "mixed")
    shutil.copyfile(os.path.join(workdir, "async.shard1"), mixed + ".shard1")
    with pytest.raises(ValueError, match="different saves"):
        restore_checkpoint(mixed, _full_template(inputs))

    both = _copy_set(workdir, "ckpt", "both")
    torch.save({}, both)
    with pytest.raises(ValueError, match="both a single-file"):
        restore_checkpoint(both, _full_template(inputs))

