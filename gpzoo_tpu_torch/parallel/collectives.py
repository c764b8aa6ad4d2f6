"""The collectives of the port's sharded paths, as autograd operations.

The JAX package annotates shardings and lets XLA's partitioner insert the
collectives. The port runs explicit SPMD instead: each rank holds plain
local tensors, and the code issues every collective itself, from the main
thread, in the same order on every rank. Only ``all_reduce`` and
``broadcast`` are used: they are the two collectives that the gloo backend
takes for CUDA tensors in PyTorch's backend table, which is what two ranks
on one card run over.

* :func:`gather_factors` — the factor axis's all-gather, as an exact
  ``all_reduce`` of a zero buffer into which each rank writes its rows.
  Its backward takes this rank's rows of the incoming gradient and sums
  nothing: what follows a gather is computed identically on every rank of
  the factor group, so each rank already holds the whole gradient.
  (``torch.distributed.nn.functional.all_gather`` reduce-scatters in its
  backward, which gives n times the gradient here.)
* :func:`sum_factors` — the sum of per-factor terms (the KL): all-reduce
  on the way forward, identity on the way back.
* :func:`first_factor` — global factor 0's hyperparameter on every rank of
  the factor group (the shared-kernel collapse): an exact all-reduce on
  the way forward, identity on the way back. It records the leaf it read;
  after the backward, :func:`route_first_rows_` sums the recorded leaves'
  first-row gradients into global factor 0.
* :func:`sum_over_data` — the sum of a minibatch term over the data axis:
  all-reduce on the way forward, n times the gradient on the way back (see
  its docstring).
* :func:`average_gradients` — the mean of the gradients over the data
  axis, before the optimizer's step.

Every reduction goes through :func:`all_reduce`, whose ``bytes`` counts
what this process has reduced.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """``dist.all_reduce`` of ``t`` in place over ``group``, its bytes
    counted."""
    all_reduce.bytes += t.numel() * t.element_size()
    dist.all_reduce(t, op=op, group=group)
    return t


all_reduce.bytes = 0


class _GatherFactors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        k = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * k
        out = x.new_zeros(shape)
        out.narrow(dim, rank * k, k).copy_(x)
        ctx.rows = (dim, rank * k, k)
        return all_reduce(out, group)

    @staticmethod
    def backward(ctx, grad):
        dim, start, k = ctx.rows
        return grad.narrow(dim, start, k).contiguous(), None, None


def gather_factors(x, group, dim=-2):
    """All ranks' blocks of ``x`` along ``dim`` (the factor axis), in the
    group's rank order; ``x`` itself when ``group`` is None. Exact: each
    entry is one rank's value plus zeros. The backward hands this rank its
    own rows of the gradient, unsummed."""
    if group is None:
        return x
    return _GatherFactors.apply(x, group, dim % x.ndim)


class _SumFactors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_factors(x, group):
    """The sum of ``x`` over the factor group, whose gradient reaches each
    rank's own terms unscaled; ``x`` when ``group`` is None."""
    if group is None:
        return x
    return _SumFactors.apply(x, group)


#: (leaf, group) of every leaf that :func:`first_factor` read since the
#: last :func:`drain_first_factor_leaves`, in the order read.
_FIRST_FACTOR_LEAVES = []


class _FirstFactor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone() if dist.get_rank(group) == 0 else torch.zeros_like(x)
        return all_reduce(out, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def first_factor(leaf, group):
    """Global factor 0's value of ``leaf`` (``leaf.reshape(-1)[0]``, where
    ``leaf`` is this rank's block of a per-factor σ or ℓ) on every rank of
    the factor group: an exact all-reduce of factor rank 0's value and
    zeros. ``leaf.reshape(-1)[0]`` when ``group`` is None.

    The backward hands each rank's gradient to its own first row, unsummed,
    so that no collective runs in the backward. Under a group the leaf is
    recorded (once, when it takes a gradient), and after
    ``loss.backward()`` every rank calls :func:`route_first_rows_` on the
    gradients of the split ones among the leaves that
    :func:`drain_first_factor_leaves` hands back: it moves the sum over the
    group into global factor 0 and clears the other ranks' first rows,
    which is the JAX package's gradient of ``reshape(-1)[0]`` of a
    factor-split leaf. (A leaf held whole is summed over the group as any
    replicated leaf is.) ``make_sharded_batched_train_step`` does this; a
    caller that runs such a loss outside it must do the same."""
    x = leaf.reshape(-1)[0]
    if group is None:
        return x
    if (torch.is_grad_enabled() and leaf.requires_grad
            and all(t is not leaf for t, _ in _FIRST_FACTOR_LEAVES)):
        _FIRST_FACTOR_LEAVES.append((leaf, group))
    return _FirstFactor.apply(x, group)


def drain_first_factor_leaves(group):
    """The leaves that :func:`first_factor` read under ``group`` since the
    last call, in the order read (the same on every rank), forgotten
    here."""
    leaves = [t for t, g in _FIRST_FACTOR_LEAVES if g is group]
    _FIRST_FACTOR_LEAVES[:] = [(t, g) for t, g in _FIRST_FACTOR_LEAVES
                               if g is not group]
    return leaves


@torch.no_grad()
def route_first_rows_(tensors, group):
    """Complete :func:`first_factor`'s gradient, in place: the first rows of
    ``tensors`` (the gradients of the collapsed σ and ℓ, each rank's block)
    are summed over the factor group in one all-reduce; factor rank 0 keeps
    the sum and every other rank sets its first row to 0."""
    if group is None or not tensors:
        return
    rows = [t.view(t.shape[0], -1)[0] for t in tensors]
    buf = all_reduce(torch.cat(rows), group)
    first = dist.get_rank(group) == 0
    for row, part in zip(rows, buf.split([r.numel() for r in rows])):
        row.copy_(part if first else torch.zeros_like(part))


def factor_block(x, group):
    """This rank's block of the leading (factor) axis of ``x``, a leaf that
    every rank of the factor group holds whole (an MGGP kernel's per-factor
    group parameter); ``x`` when ``group`` is None or ``x`` has no factor
    axis (a scalar, or a leading dimension of 1). A view: its gradient
    reaches this rank's rows of ``x`` and zeros elsewhere."""
    if group is None or x.ndim == 0 or x.shape[0] == 1:
        return x
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} factors cannot be split over a factor "
                         f"group of {n} ranks")
    k = x.shape[0] // n
    return x.narrow(0, dist.get_rank(group) * k, k)


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.n, None


def sum_over_data(x, group):
    """The sum of a minibatch term (the expected log-likelihood) over the
    data group; ``x`` when ``group`` is None.

    The losses do not scale the minibatch's log-likelihood by N/B, and their
    KL is a constant of the batch, so a rank's own −ELBO is not an estimate
    of the global one. With this operation a loss's value is the global
    −ELBO on every rank, and its gradient on each of the n ranks is that of
    −n·(its own block's term) + KL, whose mean over the data ranks
    (:func:`average_gradients`) is exactly the gradient of the global
    −ELBO."""
    if group is None:
        return x
    return _SumOverData.apply(x, group)


@torch.no_grad()
def average_(tensors, group):
    """Replace each tensor, in place, by its mean over ``group``: an
    all-reduce SUM, then a division by the group's size. Nothing happens
    when ``group`` is None."""
    if group is None:
        return
    n = dist.get_world_size(group)
    for t in tensors:
        all_reduce(t, group).div_(n)


@torch.no_grad()
def sum_(tensors, group):
    """Replace each tensor, in place, by its sum over ``group`` (nothing
    when ``group`` is None)."""
    if group is None:
        return
    for t in tensors:
        all_reduce(t, group)


def average_gradients(params, group):
    """Replace each parameter's gradient by its mean over the data group
    (:func:`average_`). Parameters without a gradient are skipped; every
    rank must skip the same ones."""
    average_([p.grad for p in params if p.grad is not None], group)


@torch.no_grad()
def broadcast(t, src=0, group=None):
    """``dist.broadcast`` of ``t`` in place from global rank ``src``."""
    dist.broadcast(t, src, group=group)
    return t


class ColumnShard:
    """This data rank's block of the columns of a (D, N) matrix (from
    ``sharding.shard_columns``): columns [start, start + width) of N, with
    ``index`` its block's position in the data group. It stands in for the
    full matrix where a loss gathers a minibatch's columns
    (:func:`take_columns`)."""

    def __init__(self, local, start, n_cols, group, index):
        self.local, self.start, self.group, self.index = local, start, group, index
        self.shape = torch.Size((*local.shape[:-1], n_cols))
        self.ndim, self.dtype, self.device = local.ndim, local.dtype, local.device

    def take(self, idx):
        """The columns at this rank's block ``idx`` of the minibatch, from
        whichever rank holds them: two exact all-reduces over the data group,
        the minibatch's indices (B integers) and a (D, B) buffer into which
        each rank writes the columns it holds (B = n·len(idx))."""
        n = dist.get_world_size(self.group) if self.group is not None else 1
        b = idx.shape[0]
        glob = torch.zeros(n * b, dtype=torch.int64, device=self.device)
        glob[self.index * b:(self.index + 1) * b] = idx
        if self.group is not None:
            all_reduce(glob, self.group)
        mine = (glob >= self.start) & (glob < self.start + self.local.shape[-1])
        cols = self.local.new_zeros((*self.local.shape[:-1], n * b))
        cols[..., mine] = self.local[..., glob[mine] - self.start]
        if self.group is not None:
            all_reduce(cols, self.group)
        return cols[..., self.index * b:(self.index + 1) * b]


def take_columns(y, idx, y_transposed=False):
    """y's spot columns at ``idx``: (D, B) from y (D, N), from y (N, D) with
    ``y_transposed``, or gathered from a :class:`ColumnShard`."""
    if isinstance(y, ColumnShard):
        if y_transposed:
            raise ValueError("a ColumnShard holds gene-major (D, N) counts; "
                             "pass y_transposed=False")
        return y.take(idx)
    return y[idx].T if y_transposed else y[:, idx]
