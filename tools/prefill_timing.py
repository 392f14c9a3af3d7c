"""Host and device time of the flash prefill forward, for one or more checkouts, on the card.

    python3 tools/prefill_timing.py [--tree DIR ...] [--reps 5]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each ``--tree`` is the root of a checkout of the port (the
default is this one; an earlier commit is unpacked with ``git archive``
into the ignored ``build/``).  The trees run in the order given and then
in the reverse order, each run in a process of its own that imports only
that tree's ``src/`` and builds its kernels there.

A run is ``chip_smoke.py``'s prefill path, timed more closely: full-width
internlm2-1.8b with random weights from seed 0, 2 x 2048 random tokens,
``transformer.forward(..., use_pallas=True)`` in bf16 and in float32 (the
same weights).  In each type: one untimed forward, then ``reps`` forwards,
each timed by the host's clock between two synchronisations and by CUDA
events, then one forward under ``torch.profiler``, whose kernels' device
time is summed (kernels only: a host operation's device time is that of
the kernels it launched), the flash kernels' apart.  Where the wall time
exceeds the device time, the difference is the host's.  Prints one JSON line per
run and writes them, with the card's name and power limit, to
``chiprun_out/prefill_timing.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
SHAPE = (2, 2048)  # chip_smoke.PREFILL_SHAPE


def run_tree(reps: int) -> dict:
    """The timings of the tree whose ``src/`` is first on ``sys.path``."""
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(ARCH)
    params = transformer.init_params(cfg)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params32 = _to_float32(params)
    B, T = SHAPE
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)).cuda()
    out = {}
    for dt, c, p in (("bfloat16", cfg, params), ("float32", cfg32, params32)):

        def forward():
            return transformer.forward(p, toks, c, use_pallas=True)[0]

        n0 = fl.flash_attention.launches
        forward()
        torch.cuda.synchronize()
        if fl.flash_attention.launches - n0 != cfg.n_layers:
            raise AssertionError(f"{dt}: not {cfg.n_layers} flash launches")
        wall, events = [], []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            forward()
            end.record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            events.append(start.elapsed_time(end) / 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        device = flash = 0.0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue  # a host op's device time is its kernels'
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            device += us
            flash += us if ("flash_kernel" in ev.key
                            or "flash_sm90_kernel" in ev.key) else 0.0
        out[dt] = {"wall_s": wall, "event_s": events,
                   "wall_median_s": statistics.median(wall),
                   "event_median_s": statistics.median(events),
                   "device_s": device / 1e6, "flash_device_s": flash / 1e6}
    return out


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_float32(v) for v in tree)
    return tree.float() if hasattr(tree, "float") else tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, action="append", default=None,
                    help="root of a checkout to time (repeatable)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        sys.path.insert(0, str(args.child.resolve() / "src"))
        print("RESULT " + json.dumps(run_tree(args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    rows = []
    for tree in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(tree), "--reps",
             str(args.reps)], capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        result = next(json.loads(line[len("RESULT "):])
                      for line in proc.stdout.splitlines()
                      if line.startswith("RESULT "))
        rows.append({"tree": str(tree), **result})
        print(json.dumps(rows[-1]), flush=True)
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "prefill_timing.json").write_text(json.dumps(
        {"card": card, "arch": ARCH, "shape": list(SHAPE), "runs": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
