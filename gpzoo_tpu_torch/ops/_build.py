"""Build and load the hand-written Hopper kernels in ``ops/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. No PyTorch header is included, so a build takes seconds. The
libraries go to ``ops/build/`` (listed in ``.gitignore``), named by a hash
of their source, so a changed source is never served by a stale library.
``nvcc -Xptxas -v`` reports each kernel's registers, shared memory and
spills; that log is kept beside its library (:func:`build_log`).
All sources are compiled in parallel on the first call in a process;
nothing is built on import, and nothing is built on a host without CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc():
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every ``csrc/*.cu`` not yet built (one ``nvcc`` each, all
    started together) and load them. Returns {name: build seconds}, 0 for
    a library found already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, seconds = {}, {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src)
        if out.exists():
            seconds[src.stem] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    for src in sorted(CSRC.glob("*.cu")):
        if src.stem not in _libs:
            _libs[src.stem] = ctypes.CDLL(str(_lib_path(src)))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (the ptxas resource report) from building
    ``csrc/<name>.cu``, or "" if the library was not built here."""
    log = _lib_path(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _libs:
        build_all()
    return _libs[name]


_tickets: dict[int, torch.Tensor] = {}


def tickets(device, count, what):
    """Ticket counters (int32) on this device for a kernel whose blocks take
    tickets (kernel 3's backward, kernel 8): zeroed once, when first asked
    for outside a CUDA graph capture, and left at zero by every launch, which
    is what lets a captured graph replay. The kernels share them and run on
    one stream at a time; two concurrent launches would clash."""
    buf = _tickets.get(device.index)
    if buf is None or buf.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what}: call it once outside a CUDA graph capture first "
                               "(its ticket counters are zeroed then)")
        buf = _tickets[device.index] = torch.zeros((count,), dtype=torch.int32,
                                                   device=device)
    return buf


def check_operands(what: str, **tensors):
    """Refuse what a kernel does not take, before any launch: each tensor
    float32, contiguous and on the first one's device, which must be a CUDA
    device."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {device}; the tensors must be "
                         f"on a CUDA device")


def check(status: int, what: str):
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
