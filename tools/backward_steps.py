#!/usr/bin/env python3
"""Step time, device idle share and device time by kernel and by operator
with its input shapes, for the three training legs that run the hand-written
backwards of kernels 3 and 5 at full width: chip_smoke.py's [vnngp] (b),
[vnngp_sweep] and [hybrid], each set up by chip_smoke.py's own helpers
(``vnngp_leg``, ``vnngp_sweep_leg``, ``hybrid_leg``) on its data and seeds.

Run from the repository root on a machine with an NVIDIA card:

    python3 tools/backward_steps.py [--package-root DIR] [--out FILE]
    python3 tools/backward_steps.py --against DIR [--out FILE]

The first form measures one tree in this process: ``--package-root``
imports ``gpzoo_tpu_torch`` from DIR instead of this checkout (for example
a ``git archive`` of another commit unpacked in a gitignored directory);
chip_smoke.py always comes from this checkout. Each leg prints its ms/step
(host clock over STEPS steps after WARMUP warm-up steps, ending in a
synchronize) and chip_smoke.py's profiled window of PROFILED steps (wall,
device busy, idle share, the kernels with the most device time, the
operators with the most self device time by input shapes). The last line
is one JSON object with each leg's figures.

The second form is the A/B: PAIRS pairs of runs, each run a process of
the first form, DIR's package against this checkout's, the order
alternating (DIR first in even pairs). It prints every run's figures, then
per leg the median, least and most ms/step and busy ms a step of each
side and the median of the pairs' differences (this checkout − DIR); the
last line is one JSON object with all of it. ``--out`` writes the last line
to FILE too. Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WARMUP = 3
STEPS = 30
PROFILED = 5
PAIRS = 10
LEGS = ("vnngp (b)", "vnngp_sweep", "hybrid")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(package_root):
    """Each leg's ms/step and profiled window, ``gpzoo_tpu_torch`` imported
    from ``package_root``."""
    sys.path.insert(0, package_root)
    import torch

    import gpzoo_tpu_torch
    from gpzoo_tpu_torch.ops import _build

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"package {os.path.dirname(gpzoo_tpu_torch.__file__)}; {smi}; torch "
          f"{torch.__version__}", flush=True)
    print(f"build: {_build.build_all()}", flush=True)
    setups = {"vnngp (b)": lambda: cs.vnngp_leg(dev, cs.vnngp_full_shape()),
              "vnngp_sweep": lambda: cs.vnngp_sweep_leg(dev),
              "hybrid": lambda: cs.hybrid_leg(dev)}
    record = {"package_root": package_root, "device": smi}
    for name in LEGS:
        _, model, step, args, *_ = setups[name]()
        cs._timed_steps(step, model, args, WARMUP)
        losses, seconds = cs._timed_steps(step, model, args, STEPS)
        ms = seconds / STEPS * 1e3
        print(f"[{name}] {ms:.3f} ms/step over {STEPS} steps; losses finite "
              f"{bool(torch.isfinite(losses).all())}", flush=True)
        window = cs.profile_window(lambda: step(model, *args), PROFILED, by_shape=True)
        record[name] = {"ms_per_step": ms,
                        "busy_ms_per_step": window and window["busy_ms"] / PROFILED,
                        "idle_share": window and window["idle_share"]}
        del step, model, args
        torch.cuda.empty_cache()
    return record


def _spread(values):
    values = [v for v in values if v is not None]
    return {"median": statistics.median(values), "min": min(values), "max": max(values)}


def against(other):
    """PAIRS alternating runs of ``other``'s package and this checkout's,
    each in its own process; their figures and each leg's summary."""
    runs = []
    for i in range(PAIRS):
        order = (("other", other), ("this", ROOT))
        for side, root in order if i % 2 == 0 else order[::-1]:
            print(f"=== pair {i + 1}, {side}: {root}", flush=True)
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--package-root", root], capture_output=True,
                                  text=True, timeout=600)
            print(proc.stdout + proc.stderr, end="", flush=True)
            if proc.returncode != 0:
                raise RuntimeError(f"pair {i + 1}, {side}: exit {proc.returncode}")
            runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                             side=side, pair=i + 1))
    summary = {}
    for leg in LEGS:
        by_side = {side: [r for r in runs if r["side"] == side] for side in ("other", "this")}
        diffs = [t[leg]["ms_per_step"] - o[leg]["ms_per_step"]
                 for o, t in zip(by_side["other"], by_side["this"])]
        summary[leg] = {side: {key: _spread([r[leg][key] for r in rs])
                               for key in ("ms_per_step", "busy_ms_per_step")}
                        for side, rs in by_side.items()}
        summary[leg]["this_minus_other_ms"] = _spread(diffs)
        for side in ("other", "this"):
            ms, busy = summary[leg][side]["ms_per_step"], summary[leg][side]["busy_ms_per_step"]
            print(f"[{leg}] {side}: ms/step median {ms['median']:.3f} (least {ms['min']:.3f}, "
                  f"most {ms['max']:.3f}); busy ms/step median {busy['median']:.3f} "
                  f"({busy['min']:.3f}-{busy['max']:.3f})")
        d = summary[leg]["this_minus_other_ms"]
        print(f"[{leg}] this - other within a pair: median {d['median']:+.3f} ms/step "
              f"({d['min']:+.3f} to {d['max']:+.3f})")
    return {"other": other, "this": ROOT, "pairs": PAIRS, "runs": runs, "summary": summary}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--package-root", default=ROOT)
    parser.add_argument("--against", default=None)
    parser.add_argument("--out", default=None)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("backward_steps: no CUDA device", file=sys.stderr)
        return 1
    record = (against(os.path.abspath(opts.against)) if opts.against
              else measure(os.path.abspath(opts.package_root)))
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(record, fh)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
