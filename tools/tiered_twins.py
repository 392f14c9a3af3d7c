"""The tiered simulation against its heapq oracle, over many seeds.

    python3 tools/tiered_twins.py [--model small|fig] [--p 0.8393]
                                  [--flows 2] [--requests 10000]
                                  [--seeds 16] [--first-seed 0]
                                  [--device cpu|cuda] [--oracle-only]
    python3 tools/tiered_twins.py --script-draw [--device cpu|cuda]

Run from the root of a checkout.  ``--model small`` is
``tests/test_hierarchy.py``'s hierarchy (2 LRU clients, 2 LRU shards, mpl
16, a 50 us origin, L2 hit ratio 0.5), ``fig`` the LRU-client hierarchy
of ``benchmarks/fig_hierarchy.py`` (3 clients, 2 shards, mpl 96, its Che
profile, a 100 us origin).  Prints one JSON line each:

* ``oracle``: the heapq oracle's throughput and delayed fractions on
  each of seeds ``--first-seed`` .. + ``--seeds`` - 1 at ``--requests``
  requests, with the throughput's mean and standard deviation;
* ``sim`` (unless ``--oracle-only``): ``simulate_hierarchy`` on
  ``--device`` (the tiered kernel on ``cuda``, its plain version on
  ``cpu``) over the same seeds, one lane each, with the same summary.

``--script-draw`` prints instead ``benchmarks/fig_hierarchy.py`` section
C's own comparison through the port: the simulation at its two p1 (grid
points 2 and 4 of its 9), seeds 0 and 1, 8 000 requests, 4 flows,
against one oracle run of 4 000 requests on seed 3, with the relative
throughput gap that the script holds to 10%.

The oracle draws the LRU head's bounded-Pareto service at its mean (see
``repro_torch.core.py_sim``); the simulators draw it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("small", "fig"), default="small")
    ap.add_argument("--p", type=float, default=0.8393)
    ap.add_argument("--flows", type=int, default=2)
    ap.add_argument("--requests", type=int, default=10_000)
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--oracle-only", action="store_true")
    ap.add_argument("--script-draw", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.hierarchy import simulate_hierarchy, simulate_hierarchy_py
    from test_torch_event_sim_cuda import hierarchy_model

    if args.script_draw:
        model = hierarchy_model("fig", cs.HI_MPL)
        lo, hi = model.profile.p_range()
        grid = np.linspace(lo + 1e-3, hi - 1e-3, cs.HI_GRID_N)
        twin_p = [float(grid[2]), float(grid[cs.HI_GRID_N // 2])]
        sim = simulate_hierarchy(model, twin_p, n_requests=cs.HI_REQUESTS,
                                 seeds=(0, 1), coalesce_flows=4,
                                 device=args.device)
        ref = [simulate_hierarchy_py(model, p, n_requests=cs.HI_REQUESTS // 2,
                                     seed=3, coalesce_flows=4)
               for p in twin_p]
        x_ref = np.array([float(r.throughput[0]) for r in ref])
        print(json.dumps({"script_draw": dict(
            p=twin_p, device=args.device, x_sim=sim.throughput.tolist(),
            x_oracle=x_ref.tolist(),
            rel_err=(np.abs(sim.throughput - x_ref) / x_ref).tolist(),
            delayed_l1_sim=sim.delayed_l1_frac.tolist(),
            delayed_l1_oracle=[float(r.delayed_l1_frac[0]) for r in ref],
            delayed_l2_sim=sim.delayed_l2_frac.tolist(),
            delayed_l2_oracle=[float(r.delayed_l2_frac[0]) for r in ref])}),
            flush=True)
        return 0
    model = hierarchy_model(args.model,
                            cs.HD_MODEL["mpl"] if args.model == "small"
                            else cs.HI_MPL)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    case = dict(model=args.model, p=args.p, flows=args.flows,
                requests=args.requests, seeds=seeds)

    def summary(x) -> dict:
        x = np.asarray(x, np.float64)
        return {"x_mean": float(x.mean()),
                "x_sd": float(x.std(ddof=1)) if x.size > 1 else 0.0}

    runs = [simulate_hierarchy_py(model, args.p, n_requests=args.requests,
                                  seed=s, coalesce_flows=args.flows)
            for s in seeds]
    x = [float(r.throughput[0]) for r in runs]
    print(json.dumps({"oracle": dict(
        case, x=x, **summary(x),
        delayed_l1=float(np.mean([r.delayed_l1_frac[0] for r in runs])),
        delayed_l2=float(np.mean([r.delayed_l2_frac[0] for r in runs])))}),
        flush=True)
    if args.oracle_only:
        return 0
    # seed s runs on lane seed 1000 * s, every seed a lane of one launch
    grid = simulate_hierarchy(model, [args.p], n_requests=args.requests,
                              seeds=tuple(seeds), coalesce_flows=args.flows,
                              device=args.device)
    sd = float(grid.ci95[0]) / 1.96 * np.sqrt(len(seeds))
    print(json.dumps({"sim": dict(
        case, device=args.device, x_mean=float(grid.throughput[0]), x_sd=sd,
        delayed_l1=float(grid.delayed_l1_frac[0]),
        delayed_l2=float(grid.delayed_l2_frac[0]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
