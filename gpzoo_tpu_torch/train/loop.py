"""Training steps and loops (port of ``TrainState``,
``trainable_mask``/``partition_optimizer`` (:func:`trainable_parameters`),
``make_train_step``, ``make_batched_train_step``, ``make_scan_runner``,
``clamp_nonnegative`` and the loops ``train``, ``train_batched``,
``train_closure_batched``, ``train_hybrid`` and ``train_hybrid_batched``
from ``gpzoo_tpu/train/loop.py``).

A minibatch step draws a without-replacement minibatch ``idx`` of the
first ``num_points`` spots and the reparameterization draws ``eps`` from
one ``torch.Generator`` on the device, then runs loss, backward and the
optimizer update; a full-batch step draws only ``eps``. :func:`run_steps`
chains K steps and returns their losses as one device tensor, so the host
waits once per K steps. The model is trained in place: a step holds its
optimizer, so the loops return the model they were given.

:class:`TrainState` gathers what decides the next step (model, optimizer,
generator, step count) for the hooks of :func:`make_scan_runner` and for
``train.checkpoint``.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from gpzoo_tpu_torch.models.factorization import (HybridNSF, HybridNSFExact,
                                                  LegacyHybridNSF)
from gpzoo_tpu_torch.models.likelihoods import ExactLikelihood


@dataclasses.dataclass
class TrainState:
    """Everything that decides the next step of a step from
    :func:`make_train_step` or :func:`make_batched_train_step`: the model,
    the optimizer and the generator that step was built over, and the
    number of steps taken (a host int: reading it costs no device sync).
    ``shardings`` is the placement map of a factor-sharded state, which
    the checkpoint reads."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0
    shardings: object = None  # set by parallel.shard_factor_params

    def advance(self, step_fn, args):
        """One step ``step_fn(model, *args)``; returns its loss."""
        loss = step_fn(self.model, *args)
        self.step += 1
        return loss

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "step": self.step}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


def trainable_parameters(model, trainable):
    """The floating-point parameters of ``model`` whose dotted path (e.g.
    ``"prior.kernel.lengthscale"``) ``trainable`` accepts, in
    ``named_parameters`` order: the list to build an optimizer over, as
    ``trainable_mask`` with ``partition_optimizer`` selects the leaves an
    optax optimizer updates."""
    return [p for path, p in model.named_parameters()
            if p.is_floating_point() and trainable(path)]


def apply_stop_gradient(model, trainable):
    """A view of ``model`` in which every parameter whose dotted path
    ``trainable`` rejects is a detached tensor over the same storage: a
    loss computed on it gives those parameters no gradient and never
    builds their backward branches, in its forward and in any recomputation
    (``torch.utils.checkpoint``) alike. The torch form of JAX's
    ``lax.stop_gradient`` on the leaves masked False. The other parameters
    and the buffers are the model's own; only the module objects are new,
    and ``model`` is left as it is."""
    memo = {id(t): t for t in model.buffers()}
    for path, p in model.named_parameters():
        memo[id(p)] = p if trainable(path) else p.detach()
    return copy.deepcopy(model, memo)


def freeze_loss(loss_fn, trainable):
    """``loss_fn`` with the parameters that ``trainable`` rejects
    stop-gradiented (:func:`apply_stop_gradient`) for its forward; use it
    with an optimizer over :func:`trainable_parameters` of the same rule."""

    def wrapped(model, *args, **kwargs):
        return loss_fn(apply_stop_gradient(model, trainable), *args, **kwargs)

    return wrapped


def clamp_nonnegative(model, field_names=("W_raw", "W2_raw")):
    """Clamp in place, to ≥ 0, every parameter whose last dotted name is one
    of ``field_names``: the post-step projection of the reference's raw
    loadings. Returns the model."""
    with torch.no_grad():
        for path, p in model.named_parameters():
            if path.split(".")[-1] in field_names:
                p.clamp_(min=0.0)
    return model


def _draws(generator, E, n_factors, batch_size):
    """``draws(model)``: the reparameterization draws of ``model``'s heads
    for a batch of ``batch_size`` spots, from ``generator`` on its device
    in the model's dtype: eps (E, n_factors, batch_size), or (E,
    batch_size) when ``n_factors`` is None (a single-output GP), then, for
    a :class:`HybridNSF` or :class:`LegacyHybridNSF`, eps2 (E, T,
    batch_size) of its T mean-field factors; none for a
    :class:`HybridNSFExact` or an :class:`ExactLikelihood`, which take no
    draws."""
    def draws(model):
        if isinstance(model, (HybridNSFExact, ExactLikelihood)):
            return {}
        dtype = next(model.parameters()).dtype

        def normal(*rows):
            return torch.randn((E, *rows, batch_size), generator=generator,
                               device=generator.device, dtype=dtype)
        out = {"eps": normal() if n_factors is None else normal(n_factors)}
        if isinstance(model, HybridNSF):
            out["eps2"] = normal(model.cf.prior.mean.shape[0])
        elif isinstance(model, LegacyHybridNSF):
            out["eps2"] = normal(model.mF.shape[0])
        return out

    return draws


def _step(loss_fn, optimizer, draw, project, loss_kwargs):
    def step(model, *args):
        kw = draw(model)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *args, **kw, **loss_kwargs)
        loss.backward()
        optimizer.step()
        if project is not None:
            project(model)
        return loss.detach()

    return step


def make_train_step(loss_fn, optimizer, batch_size, n_factors, generator, E=1,
                    loss_kwargs=None, project=None):
    """Build the full-batch ``step(model, *args) → loss`` (a detached device
    scalar): ``loss_fn(model, *args, eps=eps, **loss_kwargs)`` over a fixed
    batch of ``batch_size`` spots (all N, or an idx among ``args``), with
    eps (and a hybrid's eps2) drawn as by :func:`make_batched_train_step`
    (``n_factors`` None for a single-output GP's (E, batch_size) eps).
    ``project`` (e.g. :func:`clamp_nonnegative`) maps the model in place
    after each update."""
    return _step(loss_fn, optimizer, _draws(generator, E, n_factors, batch_size),
                 project, dict(loss_kwargs or {}))


def make_batched_train_step(loss_fn, optimizer, num_points, batch_size,
                            n_factors, generator, E=1, loss_kwargs=None):
    """Build ``step(model, *args) → loss`` (a detached device scalar).

    ``loss_fn(model, *args, idx=idx, eps=eps, **loss_kwargs)`` gets idx
    (batch_size,) from ``torch.randperm(num_points)`` and eps
    (E, n_factors, batch_size) standard normal in the model's dtype, both
    drawn from ``generator`` on its device, in that order. A
    :class:`HybridNSF` also gets ``eps2`` (E, T, batch_size), drawn next;
    a :class:`HybridNSFExact` gets neither eps nor eps2. ``loss_kwargs``
    pass through unchanged, e.g. the MGGP loss's ``groups``.
    """
    draw = _draws(generator, E, n_factors, batch_size)

    def draw_batch(model):
        idx = torch.randperm(num_points, generator=generator,
                             device=generator.device)[:batch_size]
        return {"idx": idx, **draw(model)}

    return _step(loss_fn, optimizer, draw_batch, None, dict(loss_kwargs or {}))


def run_steps(step, model, args, steps):
    """Run ``steps`` steps; returns their losses as one (steps,) tensor on
    the device, without waiting for it."""
    return torch.stack([step(model, *args) for _ in range(steps)])


def make_scan_runner(step, chunk_size, on_chunk=None):
    """``runner(state, *args) → (state, losses)``: ``chunk_size`` steps of
    ``state.advance(step, args)`` (a :class:`TrainState` over a step of
    :func:`make_batched_train_step` or :func:`make_train_step`, or an
    ``NGDTrainState`` over a step of ``make_ngd_train_step``), then one
    host sync that fetches their losses as a (chunk_size,) CPU tensor,
    then ``on_chunk(state, losses)`` if given (a ``CheckpointHook`` or a
    ``PosteriorSnapshotter``). The state is trained in place."""

    def runner(state, *args):
        losses = torch.stack([state.advance(step, args)
                              for _ in range(chunk_size)]).cpu()
        if on_chunk is not None:
            on_chunk(state, losses)
        return state, losses

    return runner


def _run_loop(step, model, x, y, steps):
    return model, run_steps(step, model, (x, y), steps).tolist()


def train(model, step, x, y, steps=200):
    """Full-batch loop: ``steps`` calls of ``step(model, x, y)`` (from
    :func:`make_train_step`, e.g. over
    :func:`gpzoo_tpu_torch.train.elbo.negative_elbo`); returns (model,
    the losses as floats)."""
    return _run_loop(step, model, x, y, steps)


def train_batched(model, step, x, y, steps=200):
    """Minibatch loop over a step from :func:`make_batched_train_step`
    (idx drawn on the device); returns (model, losses)."""
    return _run_loop(step, model, x, y, steps)


def train_closure_batched(model, step, x, y, steps=200):
    """The reference's loop for closure-style optimizers: the same loop,
    since a step holds its optimizer; returns (model, losses)."""
    return _run_loop(step, model, x, y, steps)


train_hybrid = train
train_hybrid_batched = train_batched
