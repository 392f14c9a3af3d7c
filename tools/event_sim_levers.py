"""The main path's event-sim device time, lever by lever, on one card.

    python3 tools/event_sim_levers.py [--baseline PATH/event_sim.cu]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  The main path of ``chip_smoke.py`` simulates four (p_hit x
seed) grids of 21 lanes (the LRU network at three disk speeds, FIFO at
100 us) and seven cache-size sweeps of five measured networks, 16k
requests each.  This script launches that work two ways:

* ``alone``: each grid, then every sweep network as a one-lane launch
  (39 launches);
* ``batched``: each grid, then each sweep's five networks as one
  five-lane launch (11 launches);

with the event-sim kernel of the checkout and, given ``--baseline``, with
an earlier ``event_sim.cu`` whose C entry ``event_sim_launch`` takes one
event budget for all lanes (built here by nvcc with the library's flags
into ``build/event_sim_baseline/``).  A sweep's networks are padded as
for the current kernel, so the earlier kernel runs the batched launches
too, given the largest of its lanes' budgets (no lane of the main path
reaches its own).  Each launch is timed alone by CUDA events.  Every run must give
every lane the same completions, events and throughput, bit for bit.
Prints the device milliseconds of each (kernel, way) and the ns per event
of the one-lane launches, with the card's name and power limit, and
writes them to ``chiprun_out/event_sim_levers.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "event_sim_baseline"


def baseline_launcher(src: Path):
    """Build the earlier kernel alone; returns launch(spec, seeds, kw)."""
    import torch
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc, check
    from repro_torch.kernels.event_sim import LaneOutputs

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
    if not lib.exists():
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", str(src), "-o",
                        str(lib)], check=True)
    fn = ctypes.CDLL(str(lib)).event_sim_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(spec, seeds, kw):
        n_l, n_k = spec.is_queue.shape
        n_b, n_r = spec.visits.shape[1:]
        ins = [a.contiguous() for a in spec._replace(
            is_queue=spec.is_queue.to(torch.int32))] + [seeds]
        outs = [torch.empty(n_l, dtype=dt, device=seeds.device) for dt in
                (torch.float32, torch.int32, torch.int32, torch.float32)]
        check(fn(*(a.data_ptr() for a in ins), *(a.data_ptr() for a in outs),
                 n_l, n_k, n_b, n_r, kw["mpl"], kw["n_requests"], kw["warmup"],
                 int(kw["max_events"].max()),
                 torch.cuda.current_stream().cuda_stream),
              "earlier event-sim kernel launch")
        return LaneOutputs(*outs)

    return launch


def workloads():
    """(name, spec, seeds, kwargs) of the main path's grids, and each
    sweep's five measured networks as five one-lane cells and as one
    five-lane grid."""
    import numpy as np
    import torch
    from chip_smoke import (DISKS, IMPL_CAPS, P_GRID, POLICY_PARAMS, SEEDS,
                            SIM_REQUESTS)
    from repro_torch.core.harness import measure_cache
    from repro_torch.core.policy_models import fifo_network, lru_network
    from repro_torch.core.simspec import compile_network
    from repro_torch.kernels import event_sim as es

    dev = torch.device("cuda")
    grids = [(f"lru disk={d}", *es.grid_lanes(
        lru_network(disk_us=d), np.asarray(P_GRID), SIM_REQUESTS, SEEDS, 0.25,
        dev)) for d in DISKS]
    grids.append(("fifo disk=100.0", *es.grid_lanes(
        fifo_network(disk_us=100.0), np.asarray(P_GRID), SIM_REQUESTS, SEEDS,
        0.25, dev)))
    sweeps = []
    for policy, params in POLICY_PARAMS.items():
        specs = []
        for c in IMPL_CAPS:
            meas = measure_cache(policy, c, key_space=4096, n_requests=60_000,
                                 device="cuda", **params)
            specs.append(compile_network(meas.network, meas.hit_ratio,
                                         device=dev))
        sweeps.append((policy, specs))
    return grids, sweeps


def timed(launch, spec, seeds, kw):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = launch(spec, seeds, kw)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def main() -> int:
    import torch
    from chip_smoke import SIM_REQUESTS, card_line
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_sim as es

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier event_sim.cu (one budget for all lanes)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    _build.load_library()
    kernels = {"current": lambda spec, seeds, kw: es.sim_lanes(spec, seeds, **kw)}
    if args.baseline:
        kernels["baseline"] = baseline_launcher(args.baseline)
    grids, sweeps = workloads()
    res, lanes = {"card": card, "requests": SIM_REQUESTS}, {}
    for kname, launch in kernels.items():
        for name, spec, seeds, kw in grids[:1]:  # module load, untimed
            launch(spec, seeds, kw)
        for way in ("alone", "batched"):
            ms, one_lane, outs = {}, [], []
            for name, spec, seeds, kw in grids:
                out, ms[name] = timed(launch, spec, seeds, kw)
                outs.append(out)
            for policy, specs in sweeps:
                if way == "alone":
                    for c, spec in enumerate(specs):
                        cell = es.pad_lanes([spec], [0], SIM_REQUESTS, 0.25)
                        out, t = timed(launch, *cell)
                        ms[f"{policy} size {c}"] = t
                        one_lane.append((t, int(out.events[0])))
                        outs.append(out)
                else:
                    grid = es.pad_lanes(specs, [0] * len(specs),
                                        SIM_REQUESTS, 0.25)
                    out, ms[f"{policy} sweep"] = timed(launch, *grid)
                    outs.append(out)
            got = {f: torch.cat([getattr(o, f) for o in outs]).cpu()
                   for f in ("x", "completed", "events")}
            want = lanes.setdefault("lanes", got)
            for f in got:
                if not torch.equal(got[f], want[f]):
                    raise AssertionError(f"{kname} {way}: lane {f} differs")
            row = {"launches": len(ms), "device_ms": sum(ms.values()),
                   "by_launch_ms": ms}
            if one_lane:
                row["one_lane_ns_per_event"] = [1e6 * t / e for t, e in one_lane]
            res[f"{kname} {way}"] = row
            print(f"{card}: {kname} kernel, {way}: {len(ms)} launches, "
                  f"{row['device_ms']:.3f} device ms", flush=True)
            if one_lane:
                nspe = row["one_lane_ns_per_event"]
                print(f"  one-lane launches: {min(nspe):.1f}-{max(nspe):.1f} "
                      f"ns per event", flush=True)
    print("every run gave every lane the same completions, events and "
          "throughput, bit for bit", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "event_sim_levers.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
