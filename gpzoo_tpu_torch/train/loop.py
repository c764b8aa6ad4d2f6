"""Minibatch training step (port of ``make_batched_train_step`` from
``gpzoo_tpu/train/loop.py``).

A step draws a without-replacement minibatch ``idx`` of the first
``num_points`` spots and the reparameterization draws ``eps`` from one
``torch.Generator`` on the device, then runs loss, backward and the
optimizer update. :func:`run_steps` chains K steps and returns their
losses as one device tensor, so the host waits once per K steps.
"""

from __future__ import annotations

import torch

from gpzoo_tpu_torch.models.factorization import HybridNSF, HybridNSFExact


def make_batched_train_step(loss_fn, optimizer, num_points, batch_size,
                            n_factors, generator, E=1, loss_kwargs=None):
    """Build ``step(model, *args) → loss`` (a detached device scalar).

    ``loss_fn(model, *args, idx=idx, eps=eps, **loss_kwargs)`` gets idx
    (batch_size,) from ``torch.randperm(num_points)`` and eps
    (E, n_factors, batch_size) standard normal in the model's dtype (its
    ``V_raw``'s, which every head has), both drawn from ``generator`` on
    its device, in that order. A :class:`HybridNSF` also gets ``eps2``
    (E, T, batch_size), the draws of its T mean-field factors, drawn next;
    a :class:`HybridNSFExact` gets neither eps nor eps2 (its rate takes no
    draws). ``loss_kwargs`` pass through unchanged, e.g. the MGGP loss's
    ``groups``.
    """
    loss_kwargs = dict(loss_kwargs or {})
    dev = generator.device

    def draws(model):
        if isinstance(model, HybridNSFExact):
            return {}

        def normal(rows):
            return torch.randn((E, rows, batch_size), generator=generator,
                               device=dev, dtype=model.V_raw.dtype)
        out = {"eps": normal(n_factors)}
        if isinstance(model, HybridNSF):
            out["eps2"] = normal(model.cf.prior.mean.shape[0])
        return out

    def step(model, *args):
        idx = torch.randperm(num_points, generator=generator,
                             device=dev)[:batch_size]
        kw = draws(model)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, *args, idx=idx, **kw, **loss_kwargs)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def run_steps(step, model, args, steps):
    """Run ``steps`` steps; returns their losses as one (steps,) tensor on
    the device, without waiting for it."""
    return torch.stack([step(model, *args) for _ in range(steps)])
