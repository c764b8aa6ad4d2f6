"""Observability: profiling, metric logging, numerical tripwires (port of
``gpzoo_tpu/utils.py``).

* :func:`profile_trace`: a ``torch.profiler`` trace around a block, written
  as a Chrome trace.
* :class:`MetricLogger`: step, loss and rate series with an optional JSONL
  sink.
* :func:`find_nonfinite`, :func:`assert_finite`, :func:`debug_nans`: NaN
  and Inf tripwires.
* :func:`tree_size_bytes`, :func:`copy_arrays`: sizes and copies of a
  model, a state or a tree of tensors.

A "tree" here is a module (its parameters and buffers, by dotted name), an
object with ``state_dict()`` (a train state, an optimizer), or nested
dicts, lists and tuples of tensors and numpy arrays.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import tempfile
import time

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """Profile the enclosed block (host, and the card when there is one)
    and write ``trace.json`` (Chrome trace format) into ``log_dir`` (default:
    a new directory under the temporary directory), which it yields::

        with profile_trace("traces/run") as log_dir:
            state, losses = runner(state, proj, y)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="gpzoo_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricLogger:
    """Scalar series logger: loss, KL, steps per second per step or chunk.

    Keeps every record in ``history`` and, given ``path``, appends it to a
    JSONL file. Host only: log values already fetched (once per chunk, not
    per step, to avoid device syncs)."""

    def __init__(self, path=None):
        self.path = path
        self.history = []
        self._t0 = time.perf_counter()
        self._last_step = 0

    def log(self, step, **scalars):
        now = time.perf_counter()
        rec = {"step": int(step), "wall": now - self._t0}
        if step > self._last_step:
            rec["steps_per_sec"] = (step - self._last_step) / max(
                now - getattr(self, "_last_time", self._t0), 1e-9)
        self._last_step = int(step)
        self._last_time = now
        for k, v in scalars.items():
            rec[k] = float(v)
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def losses(self, key="loss"):
        return [r[key] for r in self.history if key in r]


def _leaves(tree, path=""):
    """(path, leaf) pairs of a tree, paths written as JAX's ``keystr``:
    ``.name`` for a module's members, ``['key']`` for a dict entry, ``[i]``
    for a list or tuple item."""
    if isinstance(tree, torch.nn.Module):
        for name, t in [*tree.named_parameters(), *tree.named_buffers()]:
            yield f"{path}.{name}", t
    elif isinstance(tree, (torch.Tensor, np.ndarray, np.generic, int, float)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif hasattr(tree, "state_dict"):
        yield from _leaves(tree.state_dict(), path)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def find_nonfinite(tree, prefix=""):
    """Paths of the floating-point leaves holding a NaN or Inf: inspect a
    model, a state or a gradient tree after a suspect step."""
    bad = []
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            bad.append(f"{prefix}{path}")
    return bad


@contextlib.contextmanager
def debug_nans(enable=True):
    """Autograd's anomaly mode for the enclosed block: a backward that
    makes a NaN raises at the op whose forward it differentiates, with that
    forward's traceback (e.g. a Cholesky of a Gram that is not positive
    definite)."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


def assert_finite(tree, name="tree"):
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def tree_size_bytes(tree):
    """Total bytes of a tree's array leaves (capacity planning)."""
    return sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf).nbytes
               for _, leaf in _leaves(tree) if hasattr(leaf, "dtype"))


def copy_arrays(tree):
    """A copy of a tree with fresh storage for every tensor and array leaf:
    a module is deep-copied, dicts, lists and tuples are rebuilt."""
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return {k: copy_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_arrays(v) for v in tree)
    return tree
