"""The simulated cluster against its key-routing oracle, at long runs.

    python3 tools/cluster_long_run.py [--device cpu|cuda] [--requests 40000]
                                      [--seeds 16] [--short 7000]

Run from the root of a checkout.  The case is ``tests/test_cluster.py``'s
LRU, Zipf theta 1, 4-shard cluster at global p 0.6 with 8 flows per shard
(mpl 48).  Prints, one JSON line each:

* ``short``: the oracle's throughput on each of seeds 3 .. seeds + 2 at
  ``--short`` requests (the differential's run length), with their mean
  and standard deviation: how far the reference test's one seed, 3, can
  lie from the rest;
* ``long``: ``chip_smoke.cluster_long_run`` at ``--requests`` over
  ``--seeds`` seeds a side, ``simulate_cluster`` on ``--device`` (the
  kernel on ``cuda``, its plain version on ``cpu``) against the oracle,
  with the gate ``chip_smoke.py`` applies.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=40_000)
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--short", type=int, default=7_000)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.cluster import (HashRing, cluster_network,
                                     ideal_shard_profile,
                                     simulate_cluster_py, zipf_key_probs)

    probs = zipf_key_probs(1024, 1.0, seed=0)
    assign = HashRing(4, vnodes=64, seed=1).assignment(1024)
    cm = cluster_network("lru", 4, profile=ideal_shard_profile(assign, probs),
                         disk_us=100.0, mpl=48)
    xs = np.array([simulate_cluster_py(cm, probs, assign, cs.CL_P_OP,
                                       n_requests=args.short, seed=seed,
                                       coalesce_flows=8)["x"]
                   for seed in range(3, 3 + args.seeds)], dtype=np.float64)
    print(json.dumps({"short": {"n_requests": args.short,
                                "seeds": [3, 2 + args.seeds],
                                "x": xs.tolist(), "mean": float(xs.mean()),
                                "sd": float(xs.std(ddof=1))}}), flush=True)
    got = cs.cluster_long_run(args.device, args.requests, args.seeds)
    print(json.dumps({"long": dict(got, device=args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
