"""Sharded training over a mesh (port of ``gpzoo_tpu/parallel/sharding.py``).

The layouts are the JAX package's:

* the minibatch is split over the ``"data"`` axis (or a product of axes,
  such as ``("hosts", "data")``): each data rank runs the loss on its
  block of the minibatch, and the gradients are averaged over the data
  axis before the optimizer's step, which then runs on every rank alike;
* the per-factor leaves (:data:`FACTOR_PARAM_NAMES`: μ (L, M), the
  Cholesky factors (L, M, M), the kernel's per-factor σ and ℓ, the
  low-rank factors, NGD's P and chol P) may be split over a ``"factor"``
  axis, and the optimizer's moments follow their parameters;
* everything else is replicated. Of the prior's replicated leaves (Z, a
  shared μ (M,) and Lu (M, M), an MGGP kernel's group parameter α (L, 1,
  1) and embedding) each factor rank holds a share of the gradient, which
  the step sums over the factor group.

Every loss of the blockwise and VNNGP families takes the factor axis: the
shared-kernel collapse reads global factor 0's σ and ℓ
(``collectives.first_factor``, whose gradients the step routes back to
factor 0), and an MGGP kernel enters by this rank's rows of α.

Unlike JAX's, the port's arrays do not carry their sharding: each rank
holds plain local tensors, and the collectives are issued by the code
(:mod:`gpzoo_tpu_torch.parallel.collectives`), in the same order on every
rank. The losses take the groups as ``factor_group=`` and ``data_group=``.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools

import torch

from gpzoo_tpu_torch.parallel.collectives import (ColumnShard,
                                                  average_gradients, broadcast,
                                                  drain_first_factor_leaves,
                                                  gather_factors,
                                                  route_first_rows_, sum_)
from gpzoo_tpu_torch.parallel.mesh import (axis_group, axis_index, axis_size,
                                           mesh_device)

# Per-factor leaves: the L-batched inducing means (L, M), raw Choleskys
# (L, M, M) and kernel hyperparameters (L, 1, 1), LowRankWSVGP's (L, M, r)
# factor and (L, M) diagonal, and an NGD state's (L, M, M) precision pair.
FACTOR_PARAM_NAMES = ("mu", "Lu_raw", "sigma", "lengthscale", "V", "d_raw",
                      "prec", "prec_chol")


@dataclasses.dataclass(frozen=True)
class Placement:
    """A tensor's layout on ``mesh``: split into equal blocks along ``dim``
    over the mesh axes ``axes`` (in row-major order of their coordinates),
    or replicated when ``axes`` is empty."""

    mesh: object
    axes: tuple = ()
    dim: int = 0

    @property
    def parts(self):
        return axis_size(self.mesh, self.axes) if self.axes else 1

    @property
    def index(self):
        return axis_index(self.mesh, self.axes) if self.axes else 0

    def block(self, t):
        """This rank's block of the full tensor ``t``."""
        if not self.axes:
            return t
        size = t.shape[self.dim]
        if size % self.parts:
            raise ValueError(f"dimension {self.dim} of size {size} is not "
                             f"divisible by the mesh axes {self.axes} "
                             f"({self.parts} ranks)")
        k = size // self.parts
        return t.narrow(self.dim, self.index * k, k)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _put(t, placement):
    if placement is None:
        return t
    return placement.block(t).to(mesh_device(placement.mesh)).contiguous()


def put_sharded(tree, shardings):
    """This rank's blocks of a tensor or a (nested) dict, list or tuple of
    tensors under one :class:`Placement` for every leaf or a structure of
    placements matching ``tree`` (None leaves a leaf as it is), on the
    mesh's device. Every rank must pass the same full values."""
    if isinstance(shardings, Placement) or shardings is None:
        return _map(tree, lambda t: _put(t, shardings))
    if isinstance(tree, torch.Tensor):
        return _put(tree, shardings)
    if isinstance(tree, dict):
        return {k: put_sharded(v, shardings[k]) for k, v in tree.items()}
    return type(tree)(put_sharded(v, s) for v, s in zip(tree, shardings))


def replicate(mesh, tree):
    """``tree`` replicated on ``mesh``: each tensor is moved to the mesh's
    device and broadcast from rank 0, so every rank holds rank 0's values.
    A module is replicated in place (its parameters and buffers) and
    returned; tensors and (nested) dicts, lists and tuples of them are
    returned as new tensors. Every rank must call it with the same
    structure and shapes."""
    device = mesh_device(mesh)
    if isinstance(tree, torch.nn.Module):
        tree.to(device)
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                broadcast(t.data)
        return tree
    return _map(tree, lambda t: broadcast(t.to(device, copy=True).contiguous()))


def shard_columns(mesh, array, axis_name="data"):
    """This data rank's block of the columns (last axis) of a (D, N)
    matrix, as a :class:`ColumnShard`: the counts y, so that each rank
    holds only its spots. A loss gathers a minibatch's columns from it with
    one all-reduce over the data axis."""
    place = Placement(mesh, (axis_name,) if isinstance(axis_name, str)
                      else tuple(axis_name), dim=array.ndim - 1)
    n = array.shape[-1]
    if n % place.parts:
        raise ValueError(f"{n} columns are not divisible by the mesh axes "
                         f"{place.axes} ({place.parts} ranks)")
    return ColumnShard(_put(array, place), place.index * (n // place.parts), n,
                       axis_group(mesh, place.axes), place.index)


@dataclasses.dataclass(frozen=True)
class FactorShardings:
    """The placement map of a factor-sharded state, from
    :func:`factor_shardings`: a leaf is split over ``axis_name`` along its
    leading dimension when its name (its last dotted name; an optimizer
    moment's is its parameter's) is in ``param_names``, it is floating
    point, and its leading dimension is ``num_factors`` (the full tensor)
    or ``num_factors`` / the axis size (this rank's block). Everything
    else is replicated. The sharded step, :func:`~gpzoo_tpu_torch.train.
    checkpoint.save_checkpoint` and ``restore_checkpoint`` read it."""

    mesh: object
    num_factors: int
    axis_name: str = "factor"
    param_names: tuple = FACTOR_PARAM_NAMES

    @property
    def placement(self):
        return Placement(self.mesh, (self.axis_name,), 0)

    def sharded(self, name, t, local):
        if name not in self.param_names or not isinstance(t, torch.Tensor):
            return False
        rows = self.num_factors // self.placement.parts if local else self.num_factors
        return t.is_floating_point() and t.ndim >= 1 and t.shape[0] == rows


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _param_names(state):
    """{optimizer state index: the parameter's dotted name} of a state with
    a model and a torch optimizer."""
    opt, model = getattr(state, "optimizer", None), getattr(state, "model", None)
    if not isinstance(opt, torch.optim.Optimizer) or model is None:
        return {}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    return {i: names.get(id(p), "") for i, p in enumerate(params)}


def named_leaves(state, state_dict=None):
    """(path, name, value) of every leaf of ``state.state_dict()`` (or of
    ``state_dict``), where path is the tuple of keys and name is what
    :class:`FactorShardings` matches: the last dotted name of the leaf's
    key, or, for a torch optimizer's per-parameter state, its
    parameter's."""
    sd = state.state_dict() if state_dict is None else state_dict
    by_index = _param_names(state)
    out = []
    for path, value in _flat(sd):
        if len(path) >= 4 and path[:2] == ("optimizer", "state"):
            name = by_index.get(path[2], "")
        else:
            name = str(path[-1]) if path else ""
        out.append((path, name.split(".")[-1], value))
    return out


def factor_shardings(mesh, tree, num_factors, axis_name="factor",
                     param_names=FACTOR_PARAM_NAMES):
    """The :class:`FactorShardings` of ``tree`` (a model or a whole train
    state) over ``axis_name``; ValueError unless ``num_factors`` is
    divisible by the axis size."""
    n = axis_size(mesh, axis_name)
    if axis_name not in mesh.mesh_dim_names or num_factors % n:
        raise ValueError(f"{num_factors} factors cannot be split over mesh "
                         f"axis {axis_name!r} of size {n} "
                         f"(axes {mesh.mesh_dim_names})")
    return FactorShardings(mesh, int(num_factors), axis_name, tuple(param_names))


@torch.no_grad()
def shard_factor_params(mesh, state, num_factors, axis_name="factor",
                        param_names=FACTOR_PARAM_NAMES):
    """Keep, in place, only this rank's block of every per-factor leaf of
    ``state`` (a model, a :class:`~gpzoo_tpu_torch.train.loop.TrainState`
    or an ``NGDTrainState``): the model's parameters and buffers, the
    optimizer's state for them, NGD's P and chol P. Parameters stay the
    same objects, so an optimizer over them keeps working, and Adam's
    moments, made at its first step, come out local. Returns ``(state,
    shardings)``; the state's ``shardings`` field records the map too."""
    shardings = factor_shardings(mesh, state, num_factors, axis_name, param_names)
    place = shardings.placement
    device = mesh_device(mesh)
    model = state if isinstance(state, torch.nn.Module) else state.model
    model.to(device)
    split = set()
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if shardings.sharded(name.split(".")[-1], t, local=False):
            t.data = place.block(t.data).contiguous()
            split.add(id(t))
    opt = getattr(state, "optimizer", None)
    if isinstance(opt, torch.optim.Optimizer):
        for p, entry in opt.state.items():
            for k, v in entry.items():
                if id(p) in split and isinstance(v, torch.Tensor) and v.ndim >= 1:
                    entry[k] = place.block(v.to(device)).contiguous()
    for name in ("prec", "prec_chol"):
        t = getattr(state, name, None)
        if isinstance(t, torch.Tensor) and shardings.sharded(name, t, local=False):
            setattr(state, name, place.block(t.to(device)).contiguous())
    if hasattr(state, "shardings"):
        state.shardings = shardings
    return state, shardings


def _batch_axes(mesh, axis_name, batch_size):
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    n_way = axis_size(mesh, axes)
    if batch_size % n_way:
        raise ValueError(f"batch_size={batch_size} not divisible by mesh axes "
                         f"{axes}={n_way}")
    return axes, n_way


def _factor_axis(mesh, shardings):
    """(the factor group, this rank's factor index, the axis size) of a
    state split by ``shardings`` (a :class:`FactorShardings`); (None, 0, 1)
    for an unsplit state (None) or a factor axis of size 1."""
    if shardings is None or shardings.placement.parts == 1:
        return None, 0, 1
    return (axis_group(mesh, shardings.axis_name), shardings.placement.index,
            shardings.placement.parts)


@torch.no_grad()
def gather_factor_params(module, shardings):
    """A copy of ``module`` (a model or GP split by
    :func:`shard_factor_params`) with every leaf that ``shardings`` splits
    gathered whole over the factor axis, one exact all-reduce each: what
    the JAX package's ``put_sharded(module, P())`` gives. Every rank of the
    factor group must call it."""
    group = _factor_axis(shardings.mesh, shardings)[0]
    whole = copy.deepcopy(module)
    if group is None:
        return whole
    for name, t in itertools.chain(whole.named_parameters(), whole.named_buffers()):
        if shardings.sharded(name.split(".")[-1], t, local=True):
            t.data = gather_factors(t.data, group, dim=0)
    return whole


def prior_replicated_params(model, shardings):
    """The parameters of ``model``'s spatial prior that ``shardings`` leaves
    whole (Z, a shared μ or kernel): each factor rank's gradient of them
    holds only its own factors' terms, so the step sums it over the factor
    group. What follows the gather (the loadings, V, a hybrid's mean-field
    half) is computed alike on every factor rank and is not summed."""
    from gpzoo_tpu_torch.train.fast import _split_head  # train imports parallel

    _, gp, _ = _split_head(model)
    if gp is None:
        return []
    return [p for name, p in gp.named_parameters()
            if not shardings.sharded(name.split(".")[-1], p, local=True)]


def _local_draws(kw, index, n_way, f_index, n_factor):
    """This rank's blocks of the step's global draws: data block ``index``
    of ``n_way`` of the last (batch) axis, and factor block ``f_index`` of
    ``n_factor`` of the rows of eps (E, L, B); a hybrid's eps2 (E, T, B)
    is cut along the batch only."""
    out = {}
    for name, t in kw.items():
        b = t.shape[-1] // n_way
        t = t[..., index * b:(index + 1) * b]
        if name == "eps" and t.ndim == 3 and n_factor > 1:
            rows = t.shape[1] // n_factor
            t = t[:, f_index * rows:(f_index + 1) * rows]
        out[name] = t
    return out


def make_sharded_batched_train_step(loss_fn, optimizer, num_points, batch_size,
                                    n_factors, generator, mesh, axis_name="data",
                                    E=1, loss_kwargs=None, project=None,
                                    donate=False, state_shardings=None):
    """Sharded form of :func:`~gpzoo_tpu_torch.train.loop.
    make_batched_train_step`: ``step(model, *args) → loss``, the global
    −ELBO (a detached device scalar, equal on every rank).

    Every rank draws the global idx (batch_size,) and eps (E, n_factors,
    batch_size) (and a hybrid's eps2) from ``generator``, seeded alike on
    every rank, in the unsharded step's order; the data rank at coordinate
    r of ``axis_name`` (one axis or a tuple, such as ``("hosts",
    "data")``) takes the block idx[r·B/n:(r+1)·B/n], as JAX's
    ``P("data")`` lays it out, and a factor rank its rows of eps. So the
    sharded step sees the unsharded step's draws. ``loss_fn`` gets
    ``data_group=`` and, for a state split by :func:`shard_factor_params`
    (pass its ``state_shardings``) over a factor axis larger than 1,
    ``factor_group=``; a ``microbatch`` in ``loss_kwargs`` is the global
    batch's chunk, so each rank runs chunks of microbatch / n. After the
    backward, the gradients of the prior's unsplit parameters are summed
    over the factor group (:func:`prior_replicated_params`); the split
    leaves that the loss read at global factor 0 (the shared-kernel
    collapse's σ and ℓ, recorded by ``collectives.first_factor``) have
    their first-row gradients summed into global factor 0 and cleared on
    the other factor ranks (``collectives.route_first_rows_``); then every
    gradient is averaged over the data axis, and ``optimizer.step()`` runs
    alike on every rank. ``project`` maps the model in place after each
    update. ``donate`` is accepted for the JAX signature and does nothing:
    the step updates in place."""
    from gpzoo_tpu_torch.train.loop import _draws  # train imports parallel

    del donate
    axes, n_way = _batch_axes(mesh, axis_name, batch_size)
    data_group = axis_group(mesh, axes)
    index = axis_index(mesh, axes)
    factor_group, f_index, n_factor = _factor_axis(mesh, state_shardings)
    upstream = []
    loss_kwargs = dict(loss_kwargs or {}, data_group=data_group)
    if factor_group is not None:
        loss_kwargs["factor_group"] = factor_group
    if "microbatch" in loss_kwargs:
        if loss_kwargs["microbatch"] % n_way:
            raise ValueError(f"microbatch={loss_kwargs['microbatch']} not "
                             f"divisible by mesh axes {axes}={n_way}")
        loss_kwargs["microbatch"] //= n_way
    draw = _draws(generator, E, n_factors, batch_size)
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(model, *args):
        idx = torch.randperm(num_points, generator=generator,
                             device=generator.device)[:batch_size]
        kw = _local_draws({"idx": idx, **draw(model)}, index, n_way, f_index,
                         n_factor)
        optimizer.zero_grad(set_to_none=True)
        drain_first_factor_leaves(factor_group)  # none but this loss's
        loss = loss_fn(model, *args, **kw, **loss_kwargs)
        loss.backward()
        if factor_group is not None:
            if not upstream:
                upstream.extend(prior_replicated_params(model, state_shardings))
            sum_([p.grad for p in upstream if p.grad is not None], factor_group)
            route_first_rows_([p.grad for p in drain_first_factor_leaves(factor_group)
                               if p.grad is not None
                               and all(p is not q for q in upstream)], factor_group)
        average_gradients(params, data_group)
        optimizer.step()
        if project is not None:
            project(model)
        return loss.detach()

    return step
