"""Periodic posterior snapshots during training (port of
``gpzoo_tpu/train/snapshot.py``).

The reference captures the GP posterior every ~10 steps of its notebook
loops and assembles the captures into factor-map animations
(Slideseq_NSF_newest_version.ipynb cells 36-39). Here that is a hook for
``make_scan_runner(on_chunk=)``: every ``every``-th chunk it evaluates the
latent posterior at a fixed probe set of spots, records percentiles of its
mean and scale (to a :class:`gpzoo_tpu_torch.utils.MetricLogger` if given)
and keeps the (L, n_probe) means as animation frames. It runs between
chunks, so the steps themselves are untouched.
"""

from __future__ import annotations

import numpy as np
import torch

from gpzoo_tpu_torch.predict import latent_posterior


class PosteriorSnapshotter:
    """``on_chunk`` callback capturing qF posterior snapshots.

    x_probe: (n_probe, dim) probe coordinates, a tensor on the model's
    device (keep n_probe modest: each snapshot is a posterior forward);
    groups: (n_probe,) labels for an MGGP prior; every: capture every
    ``every``-th chunk; logger: a :class:`~gpzoo_tpu_torch.utils.MetricLogger`
    that gets each record; keep_arrays: keep the (L, n_probe) posterior
    means in ``history`` (the frames), False for long runs that need only
    the records."""

    def __init__(self, x_probe, groups=None, every=1, logger=None,
                 keep_arrays=True):
        self.x_probe = x_probe
        self.groups = groups
        self.every = int(every)
        self.logger = logger
        self.keep_arrays = keep_arrays
        self.history = []  # (step, mean (L, n_probe) ndarray)
        self.records = []  # dict summaries
        self._chunks = 0

    @torch.no_grad()
    def __call__(self, state, losses):
        self._chunks += 1
        if self._chunks % self.every:
            return
        model = state.model
        gp = model.prior if hasattr(model, "prior") else model.gp
        mean, scale = latent_posterior(gp, self.x_probe, groups=self.groups)
        mean = mean.cpu().numpy()
        scale = scale.cpu().numpy()
        rec = {
            "step": state.step,
            "loss": float(np.asarray(losses)[-1]),
            "qf_mean_p05": float(np.percentile(mean, 5)),
            "qf_mean_p50": float(np.percentile(mean, 50)),
            "qf_mean_p95": float(np.percentile(mean, 95)),
            "qf_scale_p50": float(np.percentile(scale, 50)),
            "qf_scale_p95": float(np.percentile(scale, 95)),
        }
        self.records.append(rec)
        if self.logger is not None:
            self.logger.log(**rec)
        if self.keep_arrays:
            self.history.append((state.step, mean))

    def save(self, path):
        """Write the frames and their steps to an ``.npz``."""
        steps = np.asarray([s for s, _ in self.history], np.int64)
        frames = (np.stack([m for _, m in self.history]) if self.history
                  else np.zeros((0,)))
        np.savez_compressed(path, steps=steps, frames=frames)
        return path
