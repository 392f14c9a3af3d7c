#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``).  Phases, each printed with its seconds:

1. device: the card's name and power limit;
2. build: ``nvcc`` builds every kernel under ``src/repro_torch/kernels/csrc``;
3. replay kernel vs its plain PyTorch version on the card, bit for bit:
   every policy but LRU at the main path's lane shape (key space 4096,
   pad 3300, window 8) on a 5000-request trace that fills every size;
4. event-sim kernel vs its plain version on the card: a network with
   deterministic service, identical event counts;
5. the main path at the benchmarks' sizes (``benchmarks/fig3_lru.py``):
   closed-loop simulations of the LRU network at three disk speeds and
   replay sweeps of every policy, with the LRU inversion and FIFO's
   monotone curve asserted, through the kernels (launch counts > 0);
6. the main path again under ``torch.profiler``: device time by kernel
   and the device's busy share;
7. full size: per-launch kernel times (CUDA events) at the main path's
   shapes, beside their plain versions' times and the work's bound; the
   plain versions' outputs are held against the kernels' (LRU replay of
   5 x 60k requests bit for bit and against the Mattson sweep; the LRU
   network's 21 lanes and one measured-network lane at 16k requests with
   identical event counts).

The line before the last two is the JSON ``kernels`` record; then the
card's name and power limit; the last line is the JSON result.  Details
go to ``chiprun_out/chip_smoke.json``.  Any failure raises: the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
P_GRID = (0.4, 0.55, 0.7, 0.8, 0.9, 0.95, 0.99)
DISKS = (500.0, 100.0, 5.0)
IMPL_CAPS = (96, 384, 1024, 2048, 3300)
POLICY_PARAMS = {
    "lru": {},
    "fifo": {},
    "prob_lru": {"q": 0.5},
    "clock": {"max_scan": 3},
    "slru": {"protected_frac": 0.5},
    "s3fifo": {"small_frac": 0.1, "max_scan": 3},
    "sieve": {},
}
# kernel and plain version draw the same uniforms through the same float32
# formulas: the same trajectory, throughput equal up to summation order
SIM_RTOL = 1e-6
CHECK_T, CHECK_FILL = 5000, 3400  # the replay check's trace and its fill


class Phases:
    """Prints each phase's wall seconds on its own line."""

    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {self.seconds[name]:.3f} s", flush=True)
        return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after one warm-up call."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def det_network(net):
    """The network with every station's service made deterministic."""
    return dataclasses.replace(net, stations=tuple(
        dataclasses.replace(s, dist="det", dist_params=()) for s in net.stations))


def hold_replay(what, kern, plain) -> int:
    """Raise unless the four replay outputs are bit-identical; returns 0."""
    import torch

    torch.cuda.synchronize()
    for a, b, name in zip(kern, plain, ("hits", "evicted", "ops", "cls")):
        if not torch.equal(a, b):
            raise AssertionError(f"replay kernel != plain: {what} {name}")
    print(f"replay {what}: kernel == plain (bit-identical)", flush=True)
    return 0


def hold_sim(what, kern, plain) -> float:
    """Raise unless completed and events are identical and the throughput
    agrees within SIM_RTOL; returns max |dx|."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    kx, px = kern.x.cpu().numpy(), plain.x.cpu().numpy()
    if not np.isfinite(kx).all():
        raise AssertionError(f"event-sim kernel: non-finite throughput ({what})")
    if not (torch.equal(kern.completed, plain.completed)
            and torch.equal(kern.events, plain.events)):
        raise AssertionError(f"event-sim kernel != plain: {what}")
    np.testing.assert_allclose(kx, px, rtol=SIM_RTOL, err_msg=what)
    err = float(np.abs(kx - px).max())
    print(f"event_sim {what}: completed/events identical, max |dx| = {err:.3g}",
          flush=True)
    return err


def check_replay(rec):
    """Every policy but LRU (held at full length in ``full_size``) at the
    main path's lane shape: key_space 4096, the five sizes (pad 3300),
    window 8 with re-issues, two seeds.  The trace opens with 3400
    distinct keys, so every size is full and evicting from then on, and
    goes on with the main path's Zipf stream."""
    import numpy as np
    from repro_torch.core.harness import coin_stream, zipf_trace
    from repro_torch.kernels import replay as kr

    keys, us = [], []
    for seed in (0, 1):
        fill = np.random.default_rng(seed).permutation(4096)[:CHECK_FILL]
        keys.append(np.concatenate(
            [fill, zipf_trace(CHECK_T - CHECK_FILL, 4096, 0.99, seed)]))
        us.append(coin_stream(CHECK_T, seed))
    keys, us = np.stack(keys), np.stack(us)
    for policy, params in POLICY_PARAMS.items():
        if policy == "lru":
            continue
        grid = kr.grid_lanes(policy, keys, us, IMPL_CAPS, key_space=4096,
                             window=8, fail_prob=0.1, device="cuda", **params)
        hold_replay(f"{policy} {grid.shape}",
                    kr.replay_lanes(policy, *grid.args, grid.key_space, grid.pad),
                    kr.replay_lanes_plain(policy, *grid.args, grid.key_space,
                                          grid.pad))
    rec["replay_max_abs_err"] = 0


def check_event_sim(rec):
    """The det network, whose trajectory fixes no float draw."""
    import numpy as np
    import torch
    from repro_torch.core.policy_models import lru_network
    from repro_torch.kernels import event_sim as es

    spec, seeds, kw = es.grid_lanes(det_network(lru_network(disk_us=20.0)),
                                    np.asarray(P_GRID), 2000, (0, 1, 2), 0.25,
                                    torch.device("cuda"))
    rec["event_sim_max_abs_err"] = hold_sim(
        "det network", es.sim_lanes(spec, seeds, **kw),
        es.sim_lanes_plain(spec, seeds, **kw))


def main_path(rec):
    import numpy as np
    from repro_torch.core.harness import sweep_cache_sizes
    from repro_torch.core.policy_models import fifo_network, lru_network
    from repro_torch.core.simulator import simulate_network

    out = {"lru_sim": {}, "sweeps": {}}
    for disk in DISKS:
        sim = simulate_network(lru_network(disk_us=disk), P_GRID,
                               n_requests=16_000, seeds=(0, 1, 2))
        x = sim.throughput
        if x.shape != (len(P_GRID),) or not np.isfinite(x).all():
            raise AssertionError(f"bad LRU simulation at disk={disk}: {x}")
        if not x[-1] < max(x):
            raise AssertionError(f"no LRU inversion at disk={disk}: {x}")
        out["lru_sim"][disk] = {"x": x.tolist(), "ci95": sim.ci95.tolist()}
        print(f"lru disk={disk}: X(p) = {np.round(x.astype(float), 4).tolist()} "
              f"(inversion: X(0.99) < max)", flush=True)
    fifo = simulate_network(fifo_network(disk_us=100.0), P_GRID,
                            n_requests=16_000, seeds=(0, 1, 2)).throughput
    if not np.all(np.diff(fifo) > -0.02 * fifo[:-1]):
        raise AssertionError(f"FIFO throughput not monotone: {fifo}")
    out["fifo_sim"] = fifo.tolist()
    for policy, params in POLICY_PARAMS.items():
        kw = {} if policy == "lru" else {"miss_latency_requests": 8}
        sweep = sweep_cache_sizes(policy, IMPL_CAPS, key_space=4096,
                                  n_requests=60_000, simulate=True,
                                  sim_requests=16_000, **kw, **params)
        for k, v in sweep.items():
            if v.shape != (len(IMPL_CAPS),) or not np.isfinite(v).all():
                raise AssertionError(f"bad sweep column {policy}.{k}: {v}")
        if not np.all(np.diff(sweep["p_hit"]) > 0):
            raise AssertionError(f"{policy}: p_hit not increasing with size")
        if policy == "fifo" and not np.all(np.diff(sweep["x_bound"]) > -1e-9):
            raise AssertionError(f"FIFO bound not monotone: {sweep['x_bound']}")
        out["sweeps"][policy] = {k: v.tolist() for k, v in sweep.items()}
        print(f"sweep {policy}: p_hit {np.round(sweep['p_hit'].astype(float), 4).tolist()} "
              f"x_sim {np.round(sweep['x_sim'], 4).tolist()}", flush=True)
    rec["main_path"] = out


def profile_main_path(rec):
    """Re-run the main path under torch.profiler: device time by kernel,
    and its share of the unprofiled main path's wall time (the profiler
    itself slows the host several-fold)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scratch = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        main_path(scratch)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            name = ("replay" if "replay_kernel" in ev.key else
                    "event_sim" if "sim_kernel" in ev.key else "other")
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3
    busy_ms = sum(by_kernel.values())
    wall_ms = rec["main_path_wall_s"] * 1e3
    rec["main_path_profile"] = {
        "profiled_wall_s": wall_s, "device_ms": by_kernel,
        "busy_share": busy_ms / wall_ms if by_kernel else None}
    print(f"main path: device ms by kernel "
          f"{json.dumps({k: round(v, 3) for k, v in by_kernel.items()})}; "
          f"busy share of the unprofiled {wall_ms:.1f} ms: "
          f"{rec['main_path_profile']['busy_share']}", flush=True)


def timed_plain(fn):
    """(result, ms) of one call of a plain version on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def full_size(rec):
    """Each kernel at the main path's shapes: timed per launch (CUDA events)
    and held against its plain version, run once on the same inputs and
    timed, and against the work's bound."""
    import numpy as np
    import torch
    from repro_torch.cache.flat import unpack_ops
    from repro_torch.cache.replay import lru_sweep
    from repro_torch.core.harness import coin_stream, measure_cache, zipf_trace
    from repro_torch.core.policy_models import lru_network
    from repro_torch.kernels import event_sim as es
    from repro_torch.kernels import replay as kr

    # replay: a sweep's launch (5 lanes x 60k requests, ks 4096, window 8)
    trace = zipf_trace(60_000, 4096, 0.99, 0)
    us = coin_stream(60_000, 0)
    per_policy = {}
    for policy, params in POLICY_PARAMS.items():
        grid = kr.grid_lanes(policy, trace, us, IMPL_CAPS, key_space=4096,
                             window=8, device="cuda", **params)
        per_policy[policy] = cuda_ms(
            lambda g=grid, p=policy: kr.replay_lanes(p, *g.args, g.key_space,
                                                     g.pad), reps=3)
    grid = kr.grid_lanes("lru", trace, us, IMPL_CAPS, key_space=4096,
                         window=8, device="cuda")
    outs = kr.replay_lanes("lru", *grid.args, grid.key_space, grid.pad)
    plain, replay_plain_ms = timed_plain(
        lambda: kr.replay_lanes_plain("lru", *grid.args, grid.key_space,
                                      grid.pad))
    hold_replay(f"lru {grid.shape}", outs, plain)
    hits, ops = lru_sweep(trace, IMPL_CAPS)
    if not (np.array_equal(outs[0].cpu().numpy(), hits)
            and np.array_equal(unpack_ops(outs[2]).cpu().numpy(), ops)):
        raise AssertionError("LRU replay kernel != Mattson sweep at full size")
    print("replay lru full size: kernel == lru_sweep (bit-identical)",
          flush=True)
    n_l, n_t = grid.args[2].shape
    evictions = int(((outs[2] >> 9) & 0x7).sum())
    replay_bytes = 4 * (n_l * 7 + 3 * n_l * n_t + 4 * n_l * n_t)
    # per request ~16 scalar operations; per eviction one masked argmin
    # over the padded slot axis (a compare and a select per slot)
    replay_ops = 16 * n_l * n_t + 2 * grid.pad * evictions

    # event sim: one disk speed's (p_hit x seed) grid, 21 lanes x 16k
    # requests, and one of the sweeps' measured-network lanes
    spec, seeds, kw = es.grid_lanes(lru_network(disk_us=100.0),
                                    np.asarray(P_GRID), 16_000, (0, 1, 2),
                                    0.25, torch.device("cuda"))
    sim_ms = cuda_ms(lambda: es.sim_lanes(spec, seeds, **kw), reps=5)
    out = es.sim_lanes(spec, seeds, **kw)
    plain, sim_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(spec, seeds, **kw))
    err = hold_sim(f"lru network {len(P_GRID)}x3 lanes", out, plain)
    meas = measure_cache("lru", 384, key_space=4096, n_requests=60_000,
                         device="cuda")
    one = es.grid_lanes(meas.network, np.asarray([meas.hit_ratio]), 16_000,
                        (0,), 0.25, torch.device("cuda"))
    sim_one_lane_ms = cuda_ms(lambda: es.sim_lanes(one[0], one[1], **one[2]),
                              reps=5)
    plain, sim_one_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(one[0], one[1], **one[2]))
    err = max(err, hold_sim("measured lru@384 network, 1 lane",
                            es.sim_lanes(one[0], one[1], **one[2]), plain))
    rec["event_sim_max_abs_err"] = max(rec["event_sim_max_abs_err"], err)
    events = int(out.events.long().sum())
    sim_bytes = sum(a.numel() * a.element_size() for a in spec) \
        + seeds.numel() * 4 + 16 * seeds.numel()
    # per event: two argmin passes over the mpl jobs (compare + select),
    # the ready-time rebase, three murmur3 draws and the service draw
    sim_ops = events * (5 * kw["mpl"] + 60)

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / SCALAR_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    rb, rby = bound(replay_bytes, replay_ops)
    sb, sby = bound(sim_bytes, sim_ops)
    rec["timing"] = {
        "replay_ms_per_policy": per_policy, "replay_plain_ms": replay_plain_ms,
        "replay_bytes": replay_bytes, "replay_ops": replay_ops,
        "replay_shape": [n_l, n_t, grid.key_space, grid.pad],
        "sim_ms": sim_ms, "sim_plain_ms": sim_plain_ms, "sim_events": events,
        "sim_one_lane_ms": sim_one_lane_ms,
        "sim_one_lane_plain_ms": sim_one_plain_ms,
        "sim_bytes": sim_bytes, "sim_ops": sim_ops,
    }
    return [
        {"name": "replay", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/replay.cu",
         "replaces": "src/repro/kernels/replay.py:110",
         "ms": per_policy["lru"], "plain_ms": replay_plain_ms,
         "bound_ms": rb, "bound_by": rby, "library_ms": None},
        {"name": "event_sim", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/kernels/event_sim.py:266",
         "ms": sim_ms, "plain_ms": sim_plain_ms,
         "bound_ms": sb, "bound_by": sby, "library_ms": None},
    ]


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import event_sim as es
    from repro_torch.kernels import replay as kr

    phases = Phases()
    card = phases.run("device", card_line)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    phases.run("build", _build.load_library)
    rec = {"card": card}
    phases.run("replay_vs_plain", check_replay, rec)
    phases.run("event_sim_vs_plain", check_event_sim, rec)

    kr.replay_lanes.launches = 0
    es.sim_lanes.launches = 0
    phases.run("main_path", main_path, rec)
    launches = {"replay": kr.replay_lanes.launches,
                "event_sim": es.sim_lanes.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched the {name} kernel")

    rec["main_path_wall_s"] = phases.seconds["main_path"]
    phases.run("main_path_profile", profile_main_path, rec)
    kernels = phases.run("full_size", full_size, rec)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["max_abs_err"] = rec[f"{k['name']}_max_abs_err"]
    rec["kernels"] = kernels
    rec["phase_seconds"] = phases.seconds
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(rec, indent=1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
