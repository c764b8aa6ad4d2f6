"""Checkpoint and deterministic resume (port of
``gpzoo_tpu/train/checkpoint.py``).

One file holds everything that decides the next step: the model's
parameters and buffers, the optimizer's state, the generator's state, the
step count, and for an ``NGDTrainState`` the precision and its Cholesky
factor. A restored run continues bit-identically: the same minibatches,
the same draws, the same losses.

A state is anything with ``state_dict()`` and ``load_state_dict()``: a
:class:`~gpzoo_tpu_torch.train.loop.TrainState`, an ``NGDTrainState``, a
module or an optimizer. The file is the port's own: ``torch.save`` of the
state dict with every tensor on the host, which ``torch.load(...,
weights_only=True)`` reads back. It does not read the JAX package's msgpack
files; a JAX state comes across through ``gpzoo_tpu_torch.convert``.

Under ``torch.distributed`` with more than one rank, a save writes one
file per rank, ``<path>.shard<rank>``: the ranks at coordinate 0 of every
axis but the factor axis write their blocks of the factor-sharded leaves
(the state's ``shardings``, from ``parallel.shard_factor_params``), and
rank 0 also writes everything else. The files carry one ``save_id``,
broadcast from rank 0, and the save returns after a barrier. A restore
reassembles the full state from a complete set and refuses a set from
different saves, an incomplete one, or a path that has both a single file
and shard files; ``shardings=`` (by default the template's own) then cuts
the per-factor leaves to this rank's blocks.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import json
import os
import random
import re
import shutil
import threading
import time

import torch
import torch.distributed as dist


def _map_tensors(tree, fn):
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _atomic_write(path, host_state):
    tmp = path + ".tmp"
    torch.save(host_state, tmp)
    os.replace(tmp, path)


def _world():
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _host_state(state):
    return _map_tensors(state.state_dict(), lambda t: t.detach().to("cpu", copy=True))


def save_checkpoint(path, state):
    """Write ``state.state_dict()`` to ``path`` (through ``path.tmp`` and a
    rename, so a crash leaves the previous file whole). Returns ``path``.
    Blocks until the bytes are on disk: :class:`AsyncCheckpointer` is the
    form that does not. With more than one rank, every rank must call it:
    it writes ``path.shard<rank>`` (module docstring)."""
    if _world() == 1:
        _atomic_write(path, _host_state(state))
        return path
    _save_shards(path, state)
    return path


def _collective_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def _barrier():
    """Every rank has reached this point: an all-reduce of one number (the
    port's collectives are all-reduce and broadcast only)."""
    dist.all_reduce(torch.zeros(1, device=_collective_device()))


def _replica_zero(shardings):
    """Whether this rank is at coordinate 0 of every mesh axis but the
    factor axis: the one copy of its factor blocks that is written."""
    mesh = shardings.mesh
    return all(c == 0 for name, c in zip(mesh.mesh_dim_names, mesh.get_coordinate())
               if name != shardings.axis_name)


def _set_path(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def _save_shards(path, state):
    from gpzoo_tpu_torch.parallel.sharding import named_leaves

    rank, world = dist.get_rank(), dist.get_world_size()
    save_id = torch.tensor([random.getrandbits(62) if rank == 0 else 0],
                           dtype=torch.int64, device=_collective_device())
    dist.broadcast(save_id, 0)
    shardings = getattr(state, "shardings", None)
    host = _host_state(state)
    blocks = {}
    if shardings is not None:
        index, parts = shardings.placement.index, shardings.placement.parts
        write = _replica_zero(shardings)
        for key, name, value in named_leaves(state, host):
            if shardings.sharded(name, value, local=True):
                k = value.shape[0]
                if write:
                    blocks[json.dumps(list(key))] = [index * k, (index + 1) * k,
                                                     parts * k, value]
                _set_path(host, key, None)
    local = {"meta": {"process_index": rank, "process_count": world,
                      "save_id": int(save_id.item())},
             "tree": host if rank == 0 else None, "blocks": blocks}
    _atomic_write(f"{path}.shard{rank}", local)
    _barrier()


def _shard_files(path):
    """The completed ``path.shard<digits>`` files (a stale ``.tmp`` left by a
    crash is not one), in rank order."""
    found = []
    for f in glob.glob(glob.escape(path) + ".shard*"):
        m = re.fullmatch(re.escape(path) + r"\.shard(\d+)", f)
        if m:
            found.append((int(m.group(1)), f))
    return [f for _, f in sorted(found)]


def _load_shards(path):
    """The full state dict reassembled from a complete, consistent shard
    set; ValueError otherwise."""
    files = _shard_files(path)
    if not files:
        raise FileNotFoundError(f"no checkpoint at {path}(.shard*)")
    loaded = [torch.load(f, map_location="cpu", weights_only=True) for f in files]
    ids = {int(d["meta"]["save_id"]) for d in loaded}
    if len(ids) != 1:
        raise ValueError(f"checkpoint {path}: shard files come from different "
                         f"saves (save_ids {sorted(ids)}); a save crashed between "
                         "ranks, restore an older step instead")
    counts = {int(d["meta"]["process_count"]) for d in loaded}
    ranks = sorted(int(d["meta"]["process_index"]) for d in loaded)
    if counts != {len(files)} or ranks != list(range(len(files))):
        raise ValueError(f"checkpoint {path}: found {len(files)} shard files but "
                         f"the save ran with {sorted(counts)} ranks")
    trees = [d["tree"] for d in loaded if d["tree"] is not None]
    if len(trees) != 1:
        raise ValueError(f"checkpoint {path}: {len(trees)} files hold the "
                         "replicated leaves, expected rank 0's alone")
    tree, full, covered = trees[0], {}, {}
    for d in loaded:
        for key, (start, stop, n, value) in d["blocks"].items():
            if key not in full:
                full[key] = value.new_zeros((n, *value.shape[1:]))
                covered[key] = 0
            full[key][start:stop] = value
            covered[key] += stop - start
    for key, value in full.items():
        if covered[key] != value.shape[0]:
            raise ValueError(f"checkpoint {path}: leaf {key} only partially "
                             "covered by the shard files (incomplete shard set)")
        _set_path(tree, tuple(json.loads(key)), value)
    return tree


def _place(tree, template, shardings):
    """Cut the factor-sharded leaves of the full ``tree`` to this rank's
    blocks."""
    from gpzoo_tpu_torch.parallel.sharding import named_leaves

    place = shardings.placement
    for key, name, value in named_leaves(template, tree):
        if shardings.sharded(name, value, local=False):
            _set_path(tree, key, place.block(value).contiguous())
    return tree


class AsyncCheckpointer:
    """:func:`save_checkpoint` that returns once the state is copied on its
    device.

    ``save(path, state)`` joins the write in flight, clones every tensor of
    the state on the current stream (the only work on the step stream) and
    hands the copy to the host, the serialization and the atomic write to a
    daemon thread. The thread copies on a stream of its own after an event
    recorded behind the clones, and holds the clones until their copy is
    done; training goes on meanwhile. The file is the state at the call.

    ``wait()`` joins the write and raises any failure it had; call it
    before reading the file and at the end of a run (the next ``save``
    joins too). A crash before the rename leaves only ``path.tmp``.
    ``write_seconds`` is the last write's time on the writer thread, from
    the device copy's wait to the rename."""

    def __init__(self):
        self._thread = None
        self._exc = None
        self.write_seconds = None

    def save(self, path, state, _after_write=None, block_snapshot=False):
        """``block_snapshot`` waits for the device copy before returning, so
        that the call's time is the whole stall of the step stream. With more
        than one rank the save is synchronous: its save-id broadcast and
        barrier are collectives, which run on the main thread."""
        self.wait()
        if _world() > 1:
            save_checkpoint(path, state)
            if _after_write is not None:
                _after_write()
            return path
        snap = [_map_tensors(state.state_dict(), lambda t: t.detach().clone())]
        event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            event = torch.cuda.Event()
            event.record()
            if block_snapshot:
                event.synchronize()

        def to_host(t):
            if t.device.type != "cuda":
                return t
            t.record_stream(torch.cuda.current_stream(t.device))
            return t.to("cpu")

        def work():
            try:
                t0 = time.perf_counter()
                if event is None:
                    host = snap.pop()
                else:
                    with torch.cuda.stream(torch.cuda.Stream()):
                        torch.cuda.current_stream().wait_event(event)
                        host = _map_tensors(snap.pop(), to_host)
                _atomic_write(path, host)
                self.write_seconds = time.perf_counter() - t0
                if _after_write is not None:
                    _after_write()
            except BaseException as exc:  # noqa: BLE001 - raised by wait()
                self._exc = exc

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="gpzoo-ckpt-writer")
        self._thread.start()
        return path

    def wait(self):
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from exc


def restore_checkpoint(path, template, shardings=None):
    """Load the checkpoint at ``path`` (one file, or a set of
    ``path.shard<rank>`` files) into ``template`` in place (its tensors keep
    their devices) and return it. ``template`` is a state of the same
    structure, e.g. from :func:`make_restore_template`. ``shardings`` (by
    default the template's ``shardings``, if any) cuts each per-factor leaf
    to this rank's block; without one the template takes the full state."""
    has_single = os.path.exists(path)
    if has_single and _shard_files(path):
        raise ValueError(f"checkpoint {path}: both a single-file checkpoint and "
                         f"{path}.shard* files exist; delete the stale layout "
                         "(they come from different runs or rank counts)")
    tree = (torch.load(path, map_location="cpu", weights_only=True) if has_single
            else _load_shards(path))
    if shardings is None:
        shardings = getattr(template, "shardings", None)
    if shardings is not None:
        tree = _place(tree, template, shardings)
    template.load_state_dict(tree)
    return template


def _fresh_optimizer(optimizer, old_model, new_model):
    """An optimizer of ``optimizer``'s class and groups over the parameters
    of ``new_model`` that stand where its own stand in ``old_model``."""
    name_of = {id(p): name for name, p in old_model.named_parameters()}
    new = dict(new_model.named_parameters())
    groups = [dict(g, params=[new[name_of[id(p)]] for p in g["params"]])
              for g in optimizer.param_groups]
    return type(optimizer)(groups)


def make_restore_template(state):
    """A state shaped like ``state`` that :func:`restore_checkpoint` can
    load into: a deep copy of its model, a fresh optimizer of the same class
    and hyperparameters over the copy (for a ``TrainState``), zeros for its
    other tensors and a new generator on the same device. A step built over
    the live state's optimizer and generator must be built anew over the
    template's."""
    model = copy.deepcopy(state.model)

    def fresh(value):
        if isinstance(value, torch.nn.Module):
            return model
        if isinstance(value, torch.optim.Optimizer):
            return _fresh_optimizer(value, state.model, model)
        if isinstance(value, torch.Generator):
            return torch.Generator(device=value.device)
        if isinstance(value, int):
            return 0
        return _map_tensors(value, torch.zeros_like)

    return dataclasses.replace(state, **{f.name: fresh(getattr(state, f.name))
                                         for f in dataclasses.fields(state)})


def _clone_checkpoint(src, dst):
    """Copy a written checkpoint to a second name, atomically per file: the
    single file, or the shard file this rank wrote."""
    if _world() > 1:
        src, dst = f"{src}.shard{dist.get_rank()}", f"{dst}.shard{dist.get_rank()}"
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _remove_checkpoint_files(ckpt_path):
    """Remove exactly one checkpoint's files (the single file, its shard
    files) and any stale ``.tmp``, never another step sharing the prefix
    (``run.step5`` must not take ``run.step50``)."""
    pat = re.compile(re.escape(ckpt_path) + r"(\.shard\d+)?(\.tmp)?$")
    for f in glob.glob(glob.escape(ckpt_path) + "*"):
        if pat.fullmatch(f):
            try:
                os.remove(f)
            except OSError:
                pass


class CheckpointHook:
    """Periodic checkpoints for ``make_scan_runner(on_chunk=)``.

    Every ``every``-th chunk writes ``<path>.step<N>`` (N the state's step
    count), keeps the newest ``keep`` of them and refreshes
    ``<path>.latest``, the file to resume from after a crash::

        hook = CheckpointHook("ckpts/run", every=10)
        runner = make_scan_runner(step, 10, on_chunk=hook)
        ...
        hook.wait()  # flush the write in flight at the end of the run
        state = restore_checkpoint(hook.latest_path, template)

    With ``async_save`` (the default) the saves go through
    :class:`AsyncCheckpointer`: the step stream stalls only for the device
    copy, and the write, the ``.latest`` copy and the rotation run on the
    writer thread. With more than one rank the saves are synchronous, each
    rank copies its own shard file to ``.latest``, and a barrier follows the
    copies, so that ``.latest``'s shard set is complete or absent."""

    def __init__(self, path, every=1, keep=2, async_save=True):
        self.path = path
        self.every = int(every)
        self.keep = int(keep)
        self.saved = []  # step-tagged paths, oldest first
        self._chunks = 0
        self._async = AsyncCheckpointer() if async_save else None

    @property
    def latest_path(self):
        return f"{self.path}.latest"

    @property
    def write_seconds(self):
        """The last async write's seconds on the writer thread (None in
        synchronous mode)."""
        return None if self._async is None else self._async.write_seconds

    def __call__(self, state, losses):
        self._chunks += 1
        if self._chunks % self.every:
            return
        tagged = f"{self.path}.step{state.step}"
        self.saved.append(tagged)
        stale = []
        while len(self.saved) > self.keep:
            stale.append(self.saved.pop(0))

        def after_write():
            # .latest copies the bytes just written; the previous write was
            # joined before this one started, so the stale files are whole
            _clone_checkpoint(tagged, self.latest_path)
            if _world() > 1:
                # .latest's shard set is complete or absent for any reader
                _barrier()
            for old in stale:
                _remove_checkpoint_files(old)

        if self._async is not None:
            self._async.save(tagged, state, _after_write=after_write)
        else:
            save_checkpoint(tagged, state)
            after_write()

    def wait(self):
        """Join the write in flight (nothing to join in synchronous mode)."""
        if self._async is not None:
            self._async.wait()
