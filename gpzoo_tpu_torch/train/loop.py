"""Training steps (port of ``make_train_step``, ``make_batched_train_step``
and ``clamp_nonnegative`` from ``gpzoo_tpu/train/loop.py``).

A minibatch step draws a without-replacement minibatch ``idx`` of the
first ``num_points`` spots and the reparameterization draws ``eps`` from
one ``torch.Generator`` on the device, then runs loss, backward and the
optimizer update; a full-batch step draws only ``eps``. :func:`run_steps`
chains K steps and returns their losses as one device tensor, so the host
waits once per K steps.
"""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.models.factorization import HybridNSF, HybridNSFExact


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
    in the model's dtype (its ``V_raw``'s, which every head has): eps
    (E, n_factors, batch_size), then, for a :class:`HybridNSF`, eps2
    (E, T, batch_size) of its T mean-field factors; none for a
    :class:`HybridNSFExact`, whose rate takes no draws."""
    def draws(model):
        if isinstance(model, HybridNSFExact):
            return {}

        def normal(rows):
            return torch.randn((E, rows, batch_size), generator=generator,
                               device=generator.device, dtype=model.V_raw.dtype)
        out = {"eps": normal(n_factors)}
        if isinstance(model, HybridNSF):
            out["eps2"] = normal(model.cf.prior.mean.shape[0])
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
    batch of ``batch_size`` spots (its idx among ``args``), with eps (and
    a hybrid's eps2) drawn as by :func:`make_batched_train_step`.
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
