"""The ranks of tests/test_torch_parallel_factor.py: the factor axis on the
shared-kernel collapse, MGGP priors, the Slideseq Hybrid-MGGP model and
the VNNGP losses, and ``latent_posterior(mesh=)`` of a factor-split GP.

Each rank (``_torch_parallel_ranks.spawn("factor", ...)``) builds every
case's model from the parent's numpy leaves in float64 on the CPU, splits
its per-factor leaves with ``shard_factor_params`` over the ``"factor"``
axis of ``inputs["mesh"]``, splits the counts by columns over the
``"data"`` axis, and runs the sharded Adam step. It reports the losses,
the gradients the optimizer applies at the first step (after the step's
reductions), the leaves after the steps and which leaves are split.
"""

from __future__ import annotations

import functools

import torch

from _torch_parallel_ranks import _coords, _leaves, _np


def _model(case):
    from gpzoo_tpu_torch.convert import (hybrid_from_numpy, mggp_nsf_from_numpy,
                                         nsf_from_numpy, vnngp_from_numpy)

    kw = dict(jitter=case["jitter"], var_floor=case["var_floor"])
    family = case["family"]
    if family == "nsf":
        model = nsf_from_numpy(case["leaves"], "cpu", torch.float64, **kw)
    elif family == "mggp":
        model = mggp_nsf_from_numpy(case["leaves"], "cpu", torch.float64, **kw)
    elif family == "hybrid_mggp":
        model = hybrid_from_numpy(case["leaves"], "cpu", torch.float64, prior="mggp",
                                  **kw)
    else:
        model = vnngp_from_numpy(case["leaves"], "cpu", torch.float64, K=case["K"],
                                 **kw)
    for name, p in model.named_parameters():
        p.requires_grad_(not any(f in name for f in case.get("frozen", ())))
    return model


def _loss(case, model, x, y):
    """(loss function, its positional args, its keyword args) of ``case``."""
    from gpzoo_tpu_torch.train import (nsf_negative_elbo_batched,
                                       precompute_vnngp_conditioning,
                                       vnngp_nsf_negative_elbo_batched,
                                       vnngp_nsf_negative_elbo_precomputed)

    kw = dict(case["loss_kw"])
    # keywords bound into the loss by a partial, out of the step's sight
    bound = {k: kw.pop(k) for k in case.get("bound", ())}
    if "groups" in case:
        kw["groups"] = torch.tensor(case["groups"])
    if case["family"] != "vnngp":  # the VNNGP losses read E off eps
        fn, args, kw = nsf_negative_elbo_batched, (x, y), dict(kw, E=case["E"])
    elif case["loss"] == "precomputed":
        # from the split model: the conditioning's kxx is this rank's rows
        fn, args = (vnngp_nsf_negative_elbo_precomputed,
                    (precompute_vnngp_conditioning(model, x), y))
    else:
        fn, args = vnngp_nsf_negative_elbo_batched, (x, y)
    return functools.partial(fn, **bound), args, kw


def _run_case(case, mesh):
    from gpzoo_tpu_torch.parallel import (make_sharded_batched_train_step,
                                          shard_columns, shard_factor_params)
    from gpzoo_tpu_torch.train import TrainState

    model = _model(case)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad],
                           lr=case["lr"])
    state = TrainState(model, opt, torch.Generator().manual_seed(case["seed"]))
    state, shardings = shard_factor_params(mesh, state, case["L"])
    x = torch.tensor(case["x"])
    y = shard_columns(mesh, torch.tensor(case["y"]), "data")
    fn, args, kw = _loss(case, model, x, y)
    step = make_sharded_batched_train_step(
        fn, opt, case["N"], case["B"], case["L"], state.generator, mesh,
        E=case["E"], loss_kwargs=kw, state_shardings=shardings)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}

    def first_grads(optimizer, *_):
        if not grads:
            grads.update({names[id(p)]: _np(p.grad) for g in optimizer.param_groups
                          for p in g["params"] if p.grad is not None})

    hook = opt.register_step_pre_hook(first_grads)
    losses = [float(state.advance(step, args)) for _ in range(case["steps"])]
    hook.remove()
    split = sorted(n for n, p in model.named_parameters()
                   if shardings.sharded(n.split(".")[-1], p, local=True))
    return {"losses": losses, "grads": grads, "leaves": _leaves(model), "split": split}


def _posterior(case, mesh):
    """latent_posterior(mesh=) of the case's GP split over the factor axis
    (``shardings=``), and of the whole GP on the same mesh."""
    from gpzoo_tpu_torch import latent_posterior
    from gpzoo_tpu_torch.parallel import shard_factor_params

    x = torch.tensor(case["x_post"])
    groups = torch.tensor(case["groups_post"]) if "groups_post" in case else None
    whole = _model(case)
    split = _model(case)
    _, shardings = shard_factor_params(mesh, split, case["L"])
    attr = "gp" if case["family"] == "mggp" else "prior"
    with torch.no_grad():
        out = {"split": latent_posterior(getattr(split, attr), x, groups=groups,
                                         mesh=mesh, shardings=shardings),
               "whole": latent_posterior(getattr(whole, attr), x, groups=groups,
                                         mesh=mesh)}
    return {k: tuple(_np(t) for t in v) for k, v in out.items()}


def scenario_factor(rank, world, workdir, inp):
    from gpzoo_tpu_torch.parallel import create_mesh

    mesh = create_mesh(inp["mesh"], device_type="cpu")
    out = {"coords": _coords(mesh)}
    for name, case in inp["cases"].items():
        out[name] = _run_case(case, mesh)
    for name, case in inp["posteriors"].items():
        out[name] = _posterior(case, mesh)
    return out
