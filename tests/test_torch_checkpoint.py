"""The port's checkpoints (``gpzoo_tpu_torch.train.checkpoint``), train
states and chunk runner, on CPU in float64: a restored run continues
bit-identically (the Adam north-star step and the NGD step), the hook's
``.latest`` and rotation, the async save and its failures, and the file's
atomic write. The contracts are the JAX package's
(tests/test_train.py, tests/test_ngd.py)."""

import glob
import os

import numpy as np
import pytest
import torch

import gpzoo_tpu_torch as gt
from gpzoo_tpu_torch.train import checkpoint as ckpt_mod
from gpzoo_tpu_torch.train.checkpoint import (AsyncCheckpointer, CheckpointHook,
                                              make_restore_template,
                                              restore_checkpoint, save_checkpoint)
from gpzoo_tpu_torch.train.loop import TrainState, make_scan_runner, trainable_parameters
from gpzoo_tpu_torch.train.ngd import HeadAdam, make_ngd_train_step, ngd_create

N, D, L, M, B = 120, 10, 2, 12, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-2, 2, (N, 2)))
    y = torch.tensor(rng.poisson(3.0, (N, D)).astype(np.float64))  # spot-major
    return x, y


def _cfg():
    return gt.SlideseqNSFConfig(D=D, N=N, L=L, M=M, batch_size=B)


def _adam_state(x):
    gen = torch.Generator().manual_seed(0)
    model = _cfg().build(gen, x)
    return TrainState(model, _cfg().optimizer(model), gen)


def _adam_step(state):
    return gt.make_batched_train_step(
        gt.nsf_negative_elbo_precomputed, state.optimizer, N, B, L, state.generator,
        loss_kwargs={"y_transposed": True})


def _ngd_state(x):
    gen = torch.Generator().manual_seed(0)
    state, opt = ngd_create(_cfg().build(gen, x), HeadAdam(1e-2), gen)
    return state, make_ngd_train_step(opt, N, B, 0.05, 10,
                                      loss_kwargs={"y_transposed": True})


def _leaves(state):
    out = {}

    def walk(tree, path):
        if isinstance(tree, torch.Tensor):
            out[path] = tree.detach().clone()
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        else:
            out[path] = tree

    walk(state.state_dict(), "")
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_trainable_parameters_select_by_path(data):
    model = _cfg().build(torch.Generator().manual_seed(0), data[0])
    got = trainable_parameters(model, _cfg().trainable)
    names = {id(p): n for n, p in model.named_parameters()}
    assert [names[id(p)] for p in got] == ["W_raw", "V_raw", "prior.mu", "prior.Lu_raw"]


@pytest.mark.parametrize("async_save", [True, False])
def test_hook_rotates_and_adam_resume_is_bit_identical(data, tmp_path, async_save):
    """CheckpointHook(every=1, keep=2) over four chunks of the north-star
    Adam step keeps step15 and step20 and a .latest; restored into a fresh
    model, optimizer and generator, the run continues with bit-identical
    losses and leaves."""
    x, y = data
    state = _adam_state(x)
    proj = gt.precompute_nsf_projection(state.model, x)
    hook = CheckpointHook(str(tmp_path / "run"), every=1, keep=2, async_save=async_save)
    runner = make_scan_runner(_adam_step(state), 5, on_chunk=hook)
    for _ in range(4):
        state, losses = runner(state, proj, y)
    hook.wait()
    assert sorted(glob.glob(str(tmp_path / "run*"))) == [
        str(tmp_path / f"run.{s}") for s in ("latest", "step15", "step20")]
    assert state.step == 20 and losses.shape == (5,) and losses.device.type == "cpu"

    template = make_restore_template(state)
    restored = restore_checkpoint(hook.latest_path, template)
    assert restored is template and restored.step == 20
    _assert_same(_leaves(restored), _leaves(state))
    _, live = make_scan_runner(_adam_step(state), 5)(state, proj, y)
    _, resumed = make_scan_runner(_adam_step(restored), 5)(restored, proj, y)
    assert torch.equal(live, resumed)
    _assert_same(_leaves(restored), _leaves(state))


def test_ngd_resume_is_bit_identical(data, tmp_path):
    """An NGD state (model, P, chol P, the head's Adam moments and count,
    generator, step) saved mid-run restores exactly, and the next steps'
    losses and leaves are bit-identical."""
    x, y = data
    state, step = _ngd_state(x)
    proj = gt.precompute_nsf_projection(state.model, x)
    runner = make_scan_runner(step, 3)
    state, _ = runner(state, proj, y)
    path = save_checkpoint(str(tmp_path / "ngd.pt"), state)
    restored = restore_checkpoint(path, make_restore_template(state))
    assert restored.step == 3 and int(restored.opt_state["count"]) == 3
    _assert_same(_leaves(restored), _leaves(state))
    _, live = runner(state, proj, y)
    _, resumed = runner(restored, proj, y)
    assert torch.equal(live, resumed)
    _assert_same(_leaves(restored), _leaves(state))


def test_file_loads_with_weights_only(data, tmp_path):
    x, _ = data
    state = _adam_state(x)
    path = save_checkpoint(str(tmp_path / "ck.pt"), state)
    loaded = torch.load(path, weights_only=True)
    assert set(loaded) == {"model", "optimizer", "generator", "step"}
    assert not os.path.exists(path + ".tmp")


def test_async_save_is_the_state_at_the_call(data, tmp_path):
    """The async save writes the state at the call although training goes
    on in place while it drains, and equals a synchronous save of it."""
    x, y = data
    state = _adam_state(x)
    proj = gt.precompute_nsf_projection(state.model, x)
    runner = make_scan_runner(_adam_step(state), 3)
    state, _ = runner(state, proj, y)
    save_checkpoint(str(tmp_path / "sync.pt"), state)
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "async.pt"), state)
    runner(state, proj, y)  # mutates the live tensors while the write drains
    ck.wait()
    a, b = (torch.load(str(tmp_path / f), weights_only=True) for f in ("sync.pt", "async.pt"))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert torch.equal(a["generator"], b["generator"]) and a["step"] == b["step"] == 3
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_async_wait_reraises_and_stays_usable(data, tmp_path):
    state = _adam_state(data[0])
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path / "no_such_dir" / "ck.pt"), state)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ck.wait()
    ck.save(str(tmp_path / "ok.pt"), state)
    ck.wait()
    assert restore_checkpoint(str(tmp_path / "ok.pt"),
                              make_restore_template(state)).step == state.step


def test_crash_before_rename_leaves_only_tmp(data, tmp_path, monkeypatch):
    """A write cut before its rename leaves ``path.tmp``; the previous
    checkpoint at the path is whole and still restores."""
    state = _adam_state(data[0])
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, state)
    state.step = 999

    def crash(*args, **kwargs):
        raise OSError("simulated crash between the write and the rename")

    ck = AsyncCheckpointer()
    monkeypatch.setattr(ckpt_mod.os, "replace", crash)
    ck.save(path, state)
    with pytest.raises(RuntimeError):
        ck.wait()
    monkeypatch.undo()
    assert os.path.exists(path + ".tmp")
    assert restore_checkpoint(path, make_restore_template(state)).step == 0


def test_rotation_is_prefix_safe(data, tmp_path):
    """Rotating out run.step5 must not remove run.step50 or run.step55."""
    state = _adam_state(data[0])
    hook = CheckpointHook(str(tmp_path / "run"), every=1, keep=10)
    for step in range(5, 61, 5):
        hook.keep = 10 if step <= 55 else 1
        state.step = step
        hook(state, None)
    hook.wait()
    assert glob.glob(str(tmp_path / "run.step*")) == [str(tmp_path / "run.step60")]
    assert restore_checkpoint(hook.latest_path, make_restore_template(state)).step == 60
