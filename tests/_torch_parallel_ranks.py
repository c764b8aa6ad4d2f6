"""The ranks of the port's multi-process tests (tests/test_torch_parallel*.py).

:func:`spawn` starts ``world`` processes with the ``spawn`` method, each of
which joins a gloo process group over a ``file://`` store in the test's
directory (no port to clash over under xdist), runs one scenario of
:data:`SCENARIOS` on the CPU with one thread, and writes what it found to
``out<rank>.pt``. The ranks import torch and the port only: the tests hold
their results against the JAX package in the parent process. Inputs and
results cross as files of numpy arrays and plain values.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

TIMEOUT = 240


def spawn(scenario, world, workdir, inputs, env=None, timeout=TIMEOUT):
    """Run ``scenario`` on ``world`` ranks; returns their results by rank.
    A rank that raises fails the call with its traceback."""
    import torch.multiprocessing as mp

    workdir = str(workdir)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    ctx = mp.start_processes(_entry, args=(world, workdir, scenario, env or {}),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"scenario {scenario!r} ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, workdir, scenario, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    from gpzoo_tpu_torch.parallel import initialize_distributed

    initialize_distributed(device_type="cpu",
                           init_method="file://" + os.path.join(workdir, "store"),
                           rank=rank, world_size=world)
    import torch.distributed as dist

    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    try:
        out = SCENARIOS[scenario](rank, world, workdir, inputs)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().cpu().numpy().copy()


def _coords(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


# --- meshes and collectives ---------------------------------------------------

def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc:
        return True
    return False


def scenario_mesh(rank, world, workdir, inp):
    import torch.distributed as dist

    from gpzoo_tpu_torch.parallel import (create_mesh, data_parallel_mesh,
                                          hybrid_mesh, put_sharded, replicate,
                                          shard_columns)
    from gpzoo_tpu_torch.parallel.collectives import (all_reduce,
                                                      average_gradients,
                                                      gather_factors,
                                                      sum_factors, sum_over_data,
                                                      take_columns)
    from gpzoo_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                               axis_size, axis_sizes)
    from gpzoo_tpu_torch.parallel.sharding import Placement

    out = {"backend": dist.get_backend()}
    mesh = create_mesh({"data": 2, "factor": 2}, device_type="cpu")
    out["shape"] = axis_sizes(mesh)
    out["coords"] = _coords(mesh)
    out["inferred"] = axis_sizes(create_mesh({"data": -1, "factor": 2}, "cpu"))
    out["dp"] = axis_sizes(data_parallel_mesh("cpu"))
    out["refused"] = [
        _raises(lambda: create_mesh({"data": 3}, "cpu")),
        _raises(lambda: create_mesh({"data": -1, "factor": 3}, "cpu")),
        _raises(lambda: create_mesh({"data": -1, "factor": -1}, "cpu")),
        _raises(lambda: hybrid_mesh({"data": 2}, {"data": 2}, "cpu")),
    ]
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    hyb = hybrid_mesh({"hosts": 2}, {"data": 2}, "cpu")
    out["hybrid_ranks"] = hyb.mesh.tolist()
    out["hybrid_local_refused"] = _raises(lambda: hybrid_mesh({"hosts": 1},
                                                              {"data": 4}, "cpu"))
    both = axis_group(hyb, ("hosts", "data"))
    out["product"] = (axis_size(hyb, ("hosts", "data")), axis_index(hyb, ("hosts", "data")),
                      dist.get_world_size(both))
    t = torch.tensor([float(rank + 1)])
    out["product_sum"] = float(all_reduce(t, both))

    # one mirror of the losses: a per-factor leaf mu (L,) feeds f = mu + z
    # (L, B) and the KL Σ mu²; the loadings W (D, L) act after the gather
    g = torch.Generator().manual_seed(0)
    mu_full = torch.randn(4, generator=g, dtype=torch.float64)
    w_full = torch.rand((3, 4), generator=g, dtype=torch.float64)
    z = torch.randn((4, 6), generator=g, dtype=torch.float64)
    c = torch.rand(6, generator=g, dtype=torch.float64)
    fg, dg = axis_group(mesh, "factor"), axis_group(mesh, "data")
    fi, di = out["coords"]["factor"], out["coords"]["data"]
    mu = mu_full[2 * fi:2 * fi + 2].clone().requires_grad_(True)
    w = w_full.clone().requires_grad_(True)
    cols = slice(3 * di, 3 * di + 3)
    f = gather_factors(mu[:, None] + z[2 * fi:2 * fi + 2, cols], fg)
    ll = torch.sum(c[cols] * (w @ torch.exp(f)))
    loss = -(sum_over_data(ll, dg) - sum_factors(torch.sum(mu ** 2), fg))
    loss.backward()
    average_gradients([mu, w], dg)
    out["loss"], out["dmu"], out["dw"] = float(loss), _np(mu.grad), _np(w.grad)

    y = torch.arange(30, dtype=torch.float64).reshape(3, 10)
    ys = shard_columns(mesh, y, "data")
    idx = torch.tensor([[9, 0, 4], [5, 1, 8]][di])
    out["take"] = (_np(take_columns(ys, idx)), _np(y[:, idx]), ys.shape == y.shape)
    out["replicated"] = _np(replicate(mesh, torch.full((2,), float(rank))))
    out["block"] = _np(put_sharded(torch.arange(8.0), Placement(mesh, ("factor",))))
    out["bytes"] = all_reduce.bytes
    return out


# --- the sharded Adam step ----------------------------------------------------

def _nsf_state(inp, mesh, shard):
    from gpzoo_tpu_torch.convert import nsf_from_numpy
    from gpzoo_tpu_torch.parallel import shard_factor_params
    from gpzoo_tpu_torch.train import TrainState

    model = nsf_from_numpy(inp["leaves"], "cpu", torch.float64, jitter=inp["jitter"])
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=inp["lr"]),
                       torch.Generator().manual_seed(inp["seed"]))
    if shard:
        state, _ = shard_factor_params(mesh, state, inp["L"])
    return state


def _leaves(model):
    return {k: _np(v) for k, v in model.named_parameters()}


def _moments(state, name):
    p = dict(state.model.named_parameters())[name]
    st = state.optimizer.state[p]
    return _np(st["exp_avg"]), _np(st["exp_avg_sq"])


def _nsf_run(inp, mesh, loss, shard, steps):
    """``steps`` sharded steps of ``loss`` ("precomputed" or "batched")."""
    from gpzoo_tpu_torch.parallel import (make_sharded_batched_train_step,
                                          shard_columns)
    from gpzoo_tpu_torch.train import (nsf_negative_elbo_batched,
                                       nsf_negative_elbo_precomputed,
                                       precompute_nsf_projection)

    state = _nsf_state(inp, mesh, shard)
    x = torch.tensor(inp["x"])
    y = shard_columns(mesh, torch.tensor(inp["y"]), "data")
    if loss == "precomputed":
        fn, args, kw = (nsf_negative_elbo_precomputed,
                        (precompute_nsf_projection(state.model, x), y), {})
    else:
        fn, args, kw = (nsf_negative_elbo_batched, (x, y),
                        {"microbatch": inp["microbatch"], "factored": True})
    step = make_sharded_batched_train_step(
        fn, state.optimizer, inp["N"], inp["B"], inp["L"], state.generator, mesh,
        E=inp["E"], loss_kwargs=kw, state_shardings=state.shardings)
    losses = [float(state.advance(step, args)) for _ in range(steps)]
    return state, step, args, losses


def scenario_step(rank, world, workdir, inp):
    from gpzoo_tpu_torch.parallel import create_mesh

    mesh = create_mesh(inp["mesh"], device_type="cpu")
    shard = axis_factor(inp["mesh"]) > 1
    out = {"coords": _coords(mesh)}
    for loss in ("precomputed", "batched"):
        state, _, _, losses = _nsf_run(inp, mesh, loss, shard, inp["steps"])
        out[loss] = {"losses": losses, "leaves": _leaves(state.model),
                     "lu_moments": _moments(state, "prior.Lu_raw")}
    if inp.get("posterior"):
        out["posterior"] = _posterior(inp, mesh)
    if inp.get("mggp"):
        out["mggp"] = _mggp_vnngp(inp["mggp"], mesh, "mggp")
        out["vnngp"] = _mggp_vnngp(inp["vnngp"], mesh, "vnngp")
    return out


def axis_factor(mesh_spec):
    return mesh_spec.get("factor", 1)


def _posterior(inp, mesh):
    from gpzoo_tpu_torch import latent_posterior
    from gpzoo_tpu_torch.convert import nsf_from_numpy

    model = nsf_from_numpy(inp["leaves"], "cpu", torch.float64, jitter=inp["jitter"])
    with torch.no_grad():
        mean, scale = latent_posterior(model.prior, torch.tensor(inp["x_post"]),
                                       chunk_size=7, mesh=mesh)
    return _np(mean), _np(scale)


def _mggp_vnngp(inp, mesh, kind):
    """2 data-parallel Adam steps of the MGGP blockwise loss or the VNNGP
    fast loss over a replicated state."""
    from gpzoo_tpu_torch.convert import mggp_nsf_from_numpy, vnngp_from_numpy
    from gpzoo_tpu_torch.parallel import (make_sharded_batched_train_step,
                                          replicate, shard_columns)
    from gpzoo_tpu_torch.train import (nsf_negative_elbo_batched,
                                       vnngp_nsf_negative_elbo_batched)

    if kind == "mggp":
        model = mggp_nsf_from_numpy(inp["leaves"], "cpu", torch.float64,
                                    jitter=inp["jitter"], var_floor=inp["var_floor"])
        fn = nsf_negative_elbo_batched
        kw = {"microbatch": inp["microbatch"], "factored": True,
              "groups": torch.tensor(inp["groups"])}
    else:
        model = vnngp_from_numpy(inp["leaves"], "cpu", torch.float64, K=inp["K"],
                                 jitter=inp["jitter"], var_floor=inp["var_floor"])
        fn, kw = vnngp_nsf_negative_elbo_batched, {"shared_kernel": True}
    replicate(mesh, model)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=inp["lr"])
    gen = torch.Generator().manual_seed(inp["seed"])
    step = make_sharded_batched_train_step(
        fn, opt, inp["N"], inp["B"], inp["L"], gen, mesh,
        axis_name=inp.get("axis", "data"), loss_kwargs=kw)
    x, y = torch.tensor(inp["x"]), shard_columns(mesh, torch.tensor(inp["y"]),
                                                  inp.get("axis", "data"))
    losses = [float(step(model, x, y)) for _ in range(inp["steps"])]
    return {"losses": losses, "leaves": _leaves(model)}


# --- NGD ------------------------------------------------------------------------

def scenario_ngd(rank, world, workdir, inp):
    from gpzoo_tpu_torch.convert import ngd_state_from_numpy
    from gpzoo_tpu_torch.parallel import (create_mesh, shard_columns,
                                          shard_factor_params)
    from gpzoo_tpu_torch.train import (HeadAdam, make_ngd_train_step,
                                       precompute_nsf_projection)

    mesh = create_mesh(inp["mesh"], device_type="cpu")
    out = {"coords": _coords(mesh)}
    for case in inp["cases"]:
        state = ngd_state_from_numpy(inp["leaves"], inp["prec"], inp["prec_chol"],
                                     HeadAdam(inp["lr"]),
                                     torch.Generator().manual_seed(inp["seed"]),
                                     "cpu", torch.float64, jitter=inp["jitter"])
        if axis_factor(inp["mesh"]) > 1:
            state, _ = shard_factor_params(mesh, state, inp["L"])
        proj = precompute_nsf_projection(state.model, torch.tensor(inp["x"]))
        y = shard_columns(mesh, torch.tensor(inp["y"]), "data")
        step = make_ngd_train_step(HeadAdam(inp["lr"]), inp["N"], inp["B"],
                                   inp["nat_lr"], inp["ramp"], E=inp["E"],
                                   mesh=mesh, max_f=case["max_f"])
        losses = [float(state.advance(step, (proj, y))) for _ in range(case["steps"])]
        out[case["name"]] = {"losses": losses, "mu": _np(state.model.prior.mu),
                             "prec": _np(state.prec), "W_raw": _np(state.model.W_raw),
                             "V_raw": _np(state.model.V_raw),
                             "rejected": int(step.rejected)}
    return out


# --- checkpoints and the DP+TP run --------------------------------------------

def scenario_checkpoint(rank, world, workdir, inp):
    from gpzoo_tpu_torch.parallel import hybrid_mesh
    from gpzoo_tpu_torch.train import (AsyncCheckpointer, CheckpointHook,
                                       make_restore_template, restore_checkpoint,
                                       save_checkpoint)

    mesh = hybrid_mesh({"hosts": 2}, {"data": 1, "factor": 2}, "cpu")
    axes = ("hosts", "data")
    out = {"coords": _coords(mesh)}
    state, step, args, losses = _nsf_run_axes(inp, mesh, axes, inp["steps"])
    out["losses"] = losses
    lu = state.model.prior.Lu_raw
    out["lu_local"] = tuple(lu.shape)
    out["lu_moment_local"] = tuple(_moments(state, "prior.Lu_raw")[0].shape)
    path = os.path.join(workdir, "ckpt")
    save_checkpoint(path, state)
    out["files"] = sorted(f for f in os.listdir(workdir) if f.startswith("ckpt"))
    restored = restore_checkpoint(path, make_restore_template(state),
                                  shardings=state.shardings)
    out["restored_equal"] = all(
        torch.equal(a, b) for a, b in zip(_tensors(restored), _tensors(state)))
    full = restore_checkpoint(path, _full_template(inp))
    out["full"] = _leaves(full.model)
    out["full_moments"] = _moments(full, "prior.Lu_raw")
    # the next step from the restored state is the live run's next step
    step_r = _rebuild_step(inp, mesh, axes, restored)
    out["resume"] = (float(state.advance(step, args)),
                     float(restored.advance(step_r, args)))
    out["resumed_equal"] = all(
        torch.equal(a, b) for a, b in zip(_tensors(restored), _tensors(state)))
    # the async form saves synchronously with more than one rank; the hook
    # clones each rank's shard file to .latest
    AsyncCheckpointer().save(os.path.join(workdir, "async"), state)
    hook = CheckpointHook(os.path.join(workdir, "run"), every=1, keep=1)
    hook(state, None)
    state.step += 1
    hook(state, None)
    hook.wait()
    out["hook_files"] = sorted(f for f in os.listdir(workdir)
                               if f.startswith(("run", "async")))
    out["mggp"] = _mggp_vnngp(dict(inp["mggp"], axis=axes), mesh, "mggp")
    out["vnngp"] = _mggp_vnngp(dict(inp["vnngp"], axis=axes), mesh, "vnngp")
    return out


def _tensors(state):
    from gpzoo_tpu_torch.parallel.sharding import named_leaves

    return [v for _, _, v in named_leaves(state) if isinstance(v, torch.Tensor)]


def _full_template(inp):
    from gpzoo_tpu_torch.train import make_restore_template

    return make_restore_template(_nsf_state(inp, None, False))


def _nsf_run_axes(inp, mesh, axes, steps):
    from gpzoo_tpu_torch.parallel import shard_columns

    state = _nsf_state(inp, mesh, True)
    x = torch.tensor(inp["x"])
    y = shard_columns(mesh, torch.tensor(inp["y"]), axes)
    step = _rebuild_step(inp, mesh, axes, state)
    losses = [float(state.advance(step, (x, y))) for _ in range(steps)]
    return state, step, (x, y), losses


def _rebuild_step(inp, mesh, axes, state):
    from gpzoo_tpu_torch.parallel import make_sharded_batched_train_step
    from gpzoo_tpu_torch.train import nsf_negative_elbo_batched

    return make_sharded_batched_train_step(
        nsf_negative_elbo_batched, state.optimizer, inp["N"], inp["B"], inp["L"],
        state.generator, mesh, axis_name=axes, E=inp["E"],
        loss_kwargs={"microbatch": inp["microbatch"], "factored": True},
        state_shardings=state.shardings)


def scenario_factor(rank, world, workdir, inp):
    from _torch_parallel_factor_ranks import scenario_factor as run

    return run(rank, world, workdir, inp)


SCENARIOS = {"mesh": scenario_mesh, "step": scenario_step, "ngd": scenario_ngd,
             "checkpoint": scenario_checkpoint, "factor": scenario_factor}


def nsf_draws(seed, n_points, batch, rows, steps, E=1):
    """The global (idx, eps) of ``steps`` unsharded steps from a CPU
    generator seeded ``seed``, in the step's order (float64 eps)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        idx = torch.randperm(n_points, generator=g)[:batch]
        eps = torch.randn((E, rows, batch), generator=g, dtype=torch.float64)
        out.append((idx.numpy(), eps.numpy()))
    return out


def stack_blocks(results, key_fn, axis_of, n):
    """Reassemble a factor-split array from the ranks' blocks: ``key_fn(out)``
    is a rank's block, ``axis_of(out)`` its factor index (n blocks)."""
    blocks = {}
    for out in results:
        blocks.setdefault(axis_of(out), key_fn(out))
    return np.concatenate([blocks[i] for i in range(n)], axis=0)
