"""The streaming sketch's cost per event, mode by mode, on one card.

    python3 tools/sketch_timing.py [--out FILE] [--reps N] [--rounds N]
                                   [--src DIR]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit (or from an earlier checkout unpacked into ``build/``, to
compare two versions of the kernels in one call: each run builds its own
library).  ``--src DIR`` times the package of the checkout at ``DIR``
(its ``src/``, its kernels built there) on this checkout's lanes and
timing, so that two versions are timed alike: run it in turns, this
checkout's and the other's, in one call.  On the lanes ``chip_smoke.py``'s
``ext_timing`` times — the closed loop and the traced closed loop on
fig_drift D's lane (LRU, 100 us disk, p 0.55), the counting
instantiation on fig_cluster C's 8-shard network, the coalescing one on
fig_delayed_hits B's network (16 flows), the open loop on fig_latency
C's, the tiered one on fig_hierarchy's, 1 500 requests each — it times
every launch with the sketch off and on (``sketch_cap`` 16, 1 ms
windows; CUDA events, the mean of ``--reps`` after a warm-up, host gaps
included, as ``ext_timing``'s; ``--rounds`` rounds, off and on in turns,
the fastest round kept and the rounds' spread written beside it), holds
the sketched outputs identical to the unsketched ones, and times the
``sketch_trace`` kernel on fig_drift A's 24 000-key stream
(``sketch_cap`` 96).  Prints ns per event off and on with the card's
name and power limit, and writes them to ``--out`` (default
``chiprun_out/sketch_timing.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]


def lanes(dev):
    """{mode: (launch, kwargs)} of the timed lanes; ``launch(**kw)`` runs
    the mode's kernel on its lane."""
    import dataclasses

    import numpy as np
    from chip_smoke import (CL_SHARDS, CL_SIM_KEYS, CL_SIM_P, DH_DISK_US,
                            DH_IO_DEPTH, EXT_TIMING_REQUESTS, FD_P, HI_MPL,
                            LAT_CO_FLOWS, LAT_CO_IO_DEPTH, LAT_CO_LAMBDA,
                            LAT_DISK_US)
    from repro_torch.core import build
    from repro_torch.kernels import event_sim as es
    from test_torch_event_sim_cuda import cluster_model, hierarchy_model

    n = EXT_TIMING_REQUESTS
    out = {}

    def grid(name, net, p, **kw):
        spec, seeds, gkw = es.grid_lanes(net, np.array([p]), n, (0,), 0.25,
                                         dev, sketch=True, **kw)
        out[name] = (lambda **k: es.sim_lanes(spec, seeds, **k), gkw)

    dnet = build("lru", disk_us=100.0)
    grid("closed", dnet, FD_P[0])
    grid("traced closed", dnet, FD_P[0], trace=64)
    cm = cluster_model(CL_SHARDS, 12 * CL_SHARDS, key_space=CL_SIM_KEYS)
    spec, seeds, ckw = es.grid_lanes(cm.network, np.array([CL_SIM_P[1]]), n,
                                     (0,), 0.25, dev, sketch=True)
    out["counting, 8 shards"] = (
        lambda **k: es.sim_lanes(spec, seeds, count_branches=True, **k), ckw)
    grid("coalescing", build("lru", disk_us=DH_DISK_US,
                             disk_servers=DH_IO_DEPTH), 0.5,
         coalesce_flows=16)
    net_c = build("lru", disk_us=LAT_DISK_US, disk_servers=LAT_CO_IO_DEPTH)
    net_c = dataclasses.replace(net_c, stations=tuple(
        dataclasses.replace(st, dist="det") if st.name == "disk" else st
        for st in net_c.stations))
    ospec, oseeds, okw = es.open_lanes(net_c, np.array([0.5]),
                                       np.array([LAT_CO_LAMBDA]), n, (0,),
                                       0.25, 256, coalesce_flows=LAT_CO_FLOWS,
                                       device=dev)
    out["open loop"] = (lambda **k: es.sim_open_lanes(ospec, oseeds, **k),
                        okw)
    hm = hierarchy_model("fig", HI_MPL)
    grid("tiered", hm.network, 0.5 * sum(hm.profile.p_range()),
         coalesce_flows=4, tiers=hm.mshr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "sketch_timing.json"))
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--src", default=None)
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import torch
    from chip_smoke import (FD_CAP, FD_STREAM, FD_WINDOW_US, card_line,
                            cuda_ms, fig_drift_stream)
    from repro_torch.kernels import sketch as ksk

    dev = torch.device("cuda")
    card = card_line()
    rows = {}
    for mode, (launch, kw) in lanes(dev).items():
        on_kw = dict(kw, sketch_cap=16, window_us=1_000.0)
        off, on = launch(**kw), launch(**on_kw)
        for f, a in off._asdict().items():
            b = getattr(on, f)
            if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                raise AssertionError(f"{mode}: sketched {f} != unsketched")
        events = int(off.events.long().sum())
        off_runs, on_runs = [], []
        for _ in range(args.rounds):
            off_runs.append(cuda_ms(lambda: launch(**kw), reps=args.reps))
            on_runs.append(cuda_ms(lambda: launch(**on_kw), reps=args.reps))
        off_ms, on_ms = min(off_runs), min(on_runs)
        rows[mode] = {"events": events, "off_ms": off_ms, "on_ms": on_ms,
                      "off_ns_per_event": off_ms * 1e6 / events,
                      "on_ns_per_event": on_ms * 1e6 / events,
                      "off_rounds_ms": off_runs, "on_rounds_ms": on_runs}
        spread = (max(on_runs) - min(on_runs)) * 1e6 / events
        print(f"{mode}: {rows[mode]['off_ns_per_event']:.1f} ns per event "
              f"off, {rows[mode]['on_ns_per_event']:.1f} on (on: "
              f"{len(on_runs)} rounds, spread {spread:.1f})", flush=True)
    keys, t, hits = fig_drift_stream(dev)
    st_ms = cuda_ms(lambda: ksk.sketch_trace_lanes(
        keys, t, hits, sketch_cap=FD_CAP, window_us=FD_WINDOW_US),
        reps=args.reps)
    rows["sketch_trace"] = {"keys": FD_STREAM, "ms": st_ms,
                            "ns_per_key": st_ms * 1e6 / FD_STREAM}
    print(f"sketch_trace: {st_ms:.3f} ms ({st_ms * 1e6 / FD_STREAM:.1f} ns "
          f"per key)", flush=True)
    import repro_torch

    package = str(Path(repro_torch.__file__).resolve().parents[1])
    print(f"{card}; the package timed: {package}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "root": str(ROOT),
                               "package": package,
                               "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
