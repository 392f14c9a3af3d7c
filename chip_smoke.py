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
5. traced event-sim kernel vs its traced plain version: the det network
   and the LRU network, 21 lanes x 2000 requests into 512-record rings
   (overflowing), decoded records field by field; the traced kernel's
   throughput, completions and events equal the untraced kernel's;
6. LRU-update kernel vs its plain version, bit for bit, at C 2048 / N 128,
   C 1000 with -1 padding and duplicates, and C 2**22 / N 4096 (timed on
   the device, with an empty batch, and per kernel);
7. the main path at the benchmarks' sizes (``benchmarks/fig3_lru.py``):
   closed-loop simulations of the LRU network at three disk speeds and
   replay sweeps of every policy, with the LRU inversion and FIFO's
   monotone curve asserted, through the kernels (launch counts > 0);
8. the traced path: the LRU network at 100 us over P_GRID x 3 seeds x 16k
   requests with lossless 16384-record rings, its records reconciled with
   the throughput, per-station utilization printed, one lane written as a
   Perfetto trace and read back (traced launch count > 0);
9. the batched-LRU path: 64 Zipf batches of 4096 ids through
   ``ops.lru_batch_update`` on a 2**22-slot recency table, held against
   each slot's last access (launch count > 0);
10. the main path again under ``torch.profiler``: device time by kernel
   and the device's busy share;
11. full size: per-launch kernel times (CUDA events) at the main path's
   shapes, beside their plain versions' times and the work's bound; the
   plain versions' outputs are held against the kernels' (LRU replay of
   5 x 60k requests bit for bit and against the Mattson sweep; one
   measured-network lane at 16k requests with identical event counts;
   the LRU network's 21 lanes x 16k requests, untraced and traced with
   lossless 16384-record rings, against one run of the traced plain
   version, records field by field).

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
SIM_REQUESTS, SEEDS = 16_000, (0, 1, 2)
TRACE_CHECK_REQUESTS, TRACE_CHECK_CAP = 2000, 512  # overflowing rings
TRACE_FULL = 16_384  # lossless at SIM_REQUESTS
# (C, N, padded with -1 and duplicated ids) of the LRU-update check
LRU_SHAPES = ((2048, 128, False), (1000, 96, True), (1 << 22, 4096, False))
LRU_PATH = (1 << 22, 4096, 64)  # slots, ids per batch, batches


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


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``, back to back: a sleep kernel holds
    the stream until the host has queued every call, so the host's cost
    per call (Python, allocation, launch) is hidden, as it is when calls
    are queued ahead of the card.  Raises if the host could not queue the
    calls within the longest sleep (a call that synchronises)."""
    import torch

    fn()
    for cycles in (1 << 23, 1 << 25, 1 << 27):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card had not reached the first call
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
    raise RuntimeError("device_ms: the host did not queue the calls ahead of "
                       "the card")


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


def hold_trace(what, kern, plain, visits, exact) -> float:
    """Raise unless the decoded trace records of every lane agree field by
    field (stamps NaN-aware: exactly, or within SIM_RTOL); returns the
    largest stamp difference."""
    import numpy as np
    import torch
    from repro_torch.obs.trace import decode_trace_grid

    torch.cuda.synchronize()
    if not torch.equal(kern.rings.n_count, kern.completed):
        raise AssertionError(f"traced kernel: n_emitted != completed ({what})")
    n_l = kern.x.shape[0]
    err = 0.0
    for a, b in zip(decode_trace_grid(kern.rings, visits, 1, n_l)[0],
                    decode_trace_grid(plain.rings, visits, 1, n_l)[0]):
        if a.n_emitted != b.n_emitted or len(a) != len(b):
            raise AssertionError(f"trace record counts differ ({what})")
        for f in ("req", "branch", "cls", "nvis", "station"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"traced kernel != plain: {what} {f}")
        for f in ("parked_us", "enter_us", "leave_us"):
            x, y = getattr(a, f), getattr(b, f)
            if exact:
                np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
            else:
                np.testing.assert_allclose(x, y, rtol=SIM_RTOL,
                                           err_msg=f"{what} {f}")
            if x.size:
                err = max(err, float(np.nanmax(np.abs(x - y), initial=0.0)))
    print(f"event_sim_traced {what}: records identical in req/branch/cls/"
          f"nvis/station, max |d stamp| = {err:.3g} us", flush=True)
    return err


def check_trace(rec):
    """The traced kernel against its traced plain version, and against the
    untraced kernel, on the det and the LRU network (21 lanes x 2000
    requests, 512-record rings: every ring overflows)."""
    import numpy as np
    import torch
    from repro_torch.core.policy_models import lru_network
    from repro_torch.kernels import event_sim as es

    nets = {"det network": det_network(lru_network(disk_us=20.0)),
            "lru network": lru_network(disk_us=100.0)}
    err = 0.0
    for what, net in nets.items():
        spec, seeds, kw = es.grid_lanes(
            net, np.asarray(P_GRID), TRACE_CHECK_REQUESTS, SEEDS, 0.25,
            torch.device("cuda"), trace=TRACE_CHECK_CAP)
        untraced_kw = {k: v for k, v in kw.items()
                       if k not in ("trace_cap", "bmiss")}
        kern = es.sim_lanes(spec, seeds, **kw)
        untraced = es.sim_lanes(spec, seeds, **untraced_kw)
        plain = es.sim_lanes_plain(spec, seeds, **kw)
        torch.cuda.synchronize()
        for f in ("x", "completed", "events", "t_measured"):
            if not torch.equal(getattr(kern, f), getattr(untraced, f)):
                raise AssertionError(f"traced kernel != untraced: {what} {f}")
        print(f"event_sim_traced {what}: x/completed/events == untraced "
              "kernel (bit-identical)", flush=True)
        hold_sim(f"traced {what}", kern, plain)
        err = max(err, hold_trace(what, kern, plain, spec.visits[0],
                                  exact=what.startswith("det")))
    rec["event_sim_traced_max_abs_err"] = err


def lru_inputs(n_slots, n_acc, padded, seed):
    """Timestamps with many ties and a batch of ids on the card; padded
    batches repeat ids and end in -1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 64, n_slots).astype(np.int32)
    acc = rng.choice(n_slots, n_acc, replace=False).astype(np.int32)
    if padded:
        acc[n_acc // 2: 3 * n_acc // 4] = acc[: n_acc // 4]
        acc[3 * n_acc // 4:] = -1
    return (torch.from_numpy(ts).cuda(), torch.from_numpy(acc).cuda())


def check_lru_update(rec):
    """The LRU-update kernel against its plain version, bit for bit, at
    three shapes.  The largest one is timed on the device (``device_ms``)
    beside the library calls ``index_fill_`` + ``argmin``, with an empty
    batch (the sweep without the marking of ids) and per kernel under
    ``torch.profiler``; the plain version and the wrapper, which
    synchronise, and the bare launch by CUDA events around calls made one
    after another (the host's cost per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cache_update as cu

    err = 0
    for i, (n_slots, n_acc, padded) in enumerate(LRU_SHAPES):
        ts, acc = lru_inputs(n_slots, n_acc, padded, seed=i)
        new_ts, victim = cu.lru_update(ts, acc, 99_999)
        want_ts, want_victim = cu.lru_update_plain(ts, acc, 99_999)
        torch.cuda.synchronize()
        err = max(err, int((new_ts - want_ts).abs().max()),
                  int(victim != want_victim))
        if not (torch.equal(new_ts, want_ts) and torch.equal(victim, want_victim)):
            raise AssertionError(f"LRU-update kernel != plain at C={n_slots}, "
                                 f"N={n_acc}")
        print(f"lru_batch_update C={n_slots} N={n_acc} padded={padded}: "
              f"kernel == plain (victim {int(victim)})", flush=True)
    # the largest shape, unpadded: one index_fill_ and one argmin compute
    # the same function
    idx = acc.long()
    empty = acc[:0]
    rec["lru_batch_update_max_abs_err"] = err
    timing = {
        "shape": [n_slots, n_acc],
        "ms": device_ms(lambda: cu.launch(ts, acc, 99_999), reps=50),
        "empty_batch_ms": device_ms(lambda: cu.launch(ts, empty, 99_999),
                                    reps=50),
        "library_ms": device_ms(lambda: torch.argmin(
            ts.clone().index_fill_(0, idx, 99_999)), reps=50),
        "launch_host_ms": cuda_ms(lambda: cu.launch(ts, acc, 99_999), reps=50),
        "wrapper_ms": cuda_ms(lambda: cu.lru_update(ts, acc, 99_999), reps=50),
        "plain_ms": cuda_ms(lambda: cu.lru_update_plain(ts, acc, 99_999),
                            reps=50),
        "bytes": 8 * n_slots + 4 * n_acc,
    }
    for what, batch in (("by_kernel_us", acc), ("empty_batch_by_kernel_us", empty)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                cu.launch(ts, batch, 99_999)
            torch.cuda.synchronize()
        timing[what] = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                name = ("sweep_kernel" if "sweep_kernel" in ev.key else
                        "argmin_kernel" if "argmin_kernel" in ev.key else
                        ev.key[:48])
                timing[what][name] = us / 20
    print("lru_batch_update C=2**22 N=4096: " + json.dumps(
        {k: v for k, v in timing.items() if k != "shape"}), flush=True)
    rec["lru_timing"] = timing


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


def traced_path(rec):
    """The LRU network at 100 us through ``simulate_network(trace=...)``
    with lossless rings: every lane's records are exactly requests
    0..n-1, and its post-warmup records over the measured interval (both
    read off the records' stamps) give the throughput; per-station
    utilization across P_GRID; one lane to Perfetto and back."""
    import numpy as np
    from repro_torch.core.policy_models import lru_network
    from repro_torch.core.simulator import simulate_network
    from repro_torch.obs.export import (read_perfetto, summarize_events,
                                        write_perfetto)
    from repro_torch.obs.metrics import trace_summary

    net = lru_network(disk_us=100.0)
    t0 = time.perf_counter()
    sim = simulate_network(net, P_GRID, n_requests=SIM_REQUESTS, seeds=SEEDS,
                           trace=TRACE_FULL)
    seconds = {"simulate_and_decode": time.perf_counter() - t0}
    warmup = int(SIM_REQUESTS * 0.25)
    names = [st.name for st in net.stations]
    util, rates = {}, {}
    for i, p in enumerate(P_GRID):
        xs = []
        for s in range(len(SEEDS)):
            tr = sim.traces[s][i]
            if tr.n_emitted != SIM_REQUESTS or tr.n_dropped:
                raise AssertionError(f"p={p} seed {s}: {tr.n_emitted} records "
                                     f"emitted, {tr.n_dropped} dropped")
            if not np.array_equal(tr.req, np.arange(SIM_REQUESTS)):
                raise AssertionError(f"p={p} seed {s}: req is not 0..n-1")
            end = tr.end_us
            t_meas = end[-1] - end[warmup - 1]
            counts = np.bincount(tr.branch[tr.req >= warmup],
                                 minlength=len(net.branches))
            xs.append(counts / t_meas)
        rate = np.mean(xs, axis=0)
        if not np.isclose(rate.sum(), sim.throughput[i], rtol=1e-5):
            raise AssertionError(f"p={p}: trace rate {rate.sum()} != "
                                 f"throughput {sim.throughput[i]}")
        rates[p] = rate.tolist()
        t0 = time.perf_counter()
        summ = trace_summary(sim.traces[0][i], len(names))
        seconds["trace_summary"] = (seconds.get("trace_summary", 0.0)
                                    + time.perf_counter() - t0)
        util[p] = {names[int(k)]: v for k, v in summ["stations"].items()}
    print("traced lru disk=100: records 0..n-1 per lane; per-branch rates "
          "from the records sum to X(p) at every p", flush=True)
    print("station busy_frac (mean occupancy) across P_GRID, seed 0:",
          flush=True)
    for p, row in util.items():
        print(f"  p={p}: " + ", ".join(
            f"{k} {v['busy_frac']:.4f} ({v['mean_occupancy_count']:.3f})"
            for k, v in row.items()), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "trace_lru_p0.7.json"
    tr = sim.traces[0][P_GRID.index(0.7)]
    t0 = time.perf_counter()
    write_perfetto(path, tr, station_names=names)
    seconds["write_perfetto"] = time.perf_counter() - t0
    summ = summarize_events(read_perfetto(path))
    if (summ["requests_count"] != len(tr)
            or summ["slices_count"] != int(tr.nvis.sum())):
        raise AssertionError(f"Perfetto round trip lost events: {summ}")
    print(f"perfetto p=0.7: {summ['slices_count']} slices, "
          f"{summ['requests_count']} requests, {summ['by_cls_count']}",
          flush=True)
    print("traced path host-clock seconds: "
          + json.dumps({k: round(v, 4) for k, v in seconds.items()}),
          flush=True)
    rec["traced_path"] = {"x": sim.throughput.tolist(),
                          "branch_rate": rates, "stations": util,
                          "perfetto": summ, "seconds": seconds}


def lru_update_path(rec):
    """A stream of Zipf access batches through ``ops.lru_batch_update`` on
    a 2**22-slot recency table (now = batch number, the last batch padded
    with -1), held against each slot's last access computed in numpy."""
    import numpy as np
    import torch
    from repro_torch.core.harness import zipf_trace
    from repro_torch.kernels.ops import lru_batch_update

    n_slots, n_acc, n_batches = LRU_PATH
    stream = zipf_trace(n_acc * n_batches, n_slots, 0.99, seed=0).astype(
        np.int32).reshape(n_batches, n_acc)
    stream[-1, -n_acc // 8:] = -1
    ts0 = -np.random.default_rng(0).integers(0, 1000, n_slots).astype(np.int32)
    ts, batches = torch.from_numpy(ts0).cuda(), torch.from_numpy(stream).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(n_batches):
        ts, victim = lru_batch_update(ts, batches[b], b + 1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    want = ts0.copy()
    for b in range(n_batches):
        want[stream[b][stream[b] >= 0]] = b + 1
    if not (np.array_equal(ts.cpu().numpy(), want)
            and int(victim) == int(np.argmin(want))):
        raise AssertionError("batched LRU path: timestamps or victim wrong")
    print(f"lru_batch_update path: {n_batches} batches x {n_acc} ids on "
          f"{n_slots} slots in {wall_s:.4f} s; timestamps == last access, "
          f"victim {int(victim)} == first argmin", flush=True)
    rec["lru_update_path"] = {"wall_s": wall_s, "victim": int(victim)}


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

    # event sim, one disk speed's (p_hit x seed) grid, 21 lanes x 16k
    # requests, untraced and traced (lossless rings), held against one run
    # of the traced plain version, whose throughput, completions and
    # events are the untraced plain version's
    spec, seeds, kw_t = es.grid_lanes(
        lru_network(disk_us=100.0), np.asarray(P_GRID), SIM_REQUESTS, SEEDS,
        0.25, torch.device("cuda"), trace=TRACE_FULL)
    kw = {k: v for k, v in kw_t.items() if k not in ("trace_cap", "bmiss")}
    sim_ms = cuda_ms(lambda: es.sim_lanes(spec, seeds, **kw), reps=5)
    traced_ms = cuda_ms(lambda: es.sim_lanes(spec, seeds, **kw_t), reps=5)
    out = es.sim_lanes(spec, seeds, **kw)
    out_t = es.sim_lanes(spec, seeds, **kw_t)
    plain, traced_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(spec, seeds, **kw_t))
    grid_what = f"lru network {len(P_GRID)}x{len(SEEDS)} lanes"
    err = hold_sim(f"{grid_what} (vs the traced plain version)", out, plain)
    for f in ("x", "completed", "events", "t_measured"):
        if not torch.equal(getattr(out_t, f), getattr(out, f)):
            raise AssertionError(f"traced kernel != untraced at full size: {f}")
    hold_sim(f"traced {grid_what}", out_t, plain)
    rec["event_sim_traced_max_abs_err"] = max(
        rec["event_sim_traced_max_abs_err"],
        hold_trace(f"{grid_what}, {TRACE_FULL}-record rings", out_t, plain,
                   spec.visits[0], exact=False))
    print(f"event_sim_traced full size: {traced_ms:.3f} ms vs untraced "
          f"{sim_ms:.3f} ms; x/completed/events identical", flush=True)
    # one of the sweeps' measured-network lanes: 35 of the main path's 39
    # untraced launches are one such lane
    meas = measure_cache("lru", 384, key_space=4096, n_requests=60_000,
                         device="cuda")
    one = es.grid_lanes(meas.network, np.asarray([meas.hit_ratio]), 16_000,
                        (0,), 0.25, torch.device("cuda"))
    sim_one_lane_ms = cuda_ms(lambda: es.sim_lanes(one[0], one[1], **one[2]),
                              reps=5)
    out_one = es.sim_lanes(one[0], one[1], **one[2])
    plain, sim_one_plain_ms = timed_plain(
        lambda: es.sim_lanes_plain(one[0], one[1], **one[2]))
    err = max(err, hold_sim("measured lru@384 network, 1 lane", out_one,
                            plain))
    rec["event_sim_max_abs_err"] = max(rec["event_sim_max_abs_err"], err)

    def sim_work(spec, seeds, mpl, out):
        """(bytes, operations) of one untraced launch."""
        nbytes = sum(a.numel() * a.element_size() for a in spec) \
            + seeds.numel() * 4 + 16 * seeds.numel()
        # per event: two argmin passes over the mpl jobs (compare +
        # select), the ready-time rebase, three murmur3 draws and the
        # service draw
        return nbytes, int(out.events.long().sum()) * (5 * mpl + 60)

    one_bytes, one_ops = sim_work(*one[:2], one[2]["mpl"], out_one)
    sim_bytes, sim_ops = sim_work(spec, seeds, kw["mpl"], out)
    # the traced launch adds the (lanes, B) miss table and the rings: every
    # completed request's record written once
    route_len = spec.visits.shape[-1]
    ring_bytes = int(out.completed.long().sum()) * (5 * 4 + 2 * route_len * 4)

    def bound(nbytes, ops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / SCALAR_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    rb, rby = bound(replay_bytes, replay_ops)
    sb, sby = bound(one_bytes, one_ops)
    tb, tby = bound(sim_bytes + 4 * seeds.numel() * spec.visits.shape[1]
                    + ring_bytes, sim_ops)
    lru = rec["lru_timing"]
    lb, lby = bound(lru["bytes"], 2 * lru["shape"][0] + lru["shape"][1])
    rec["timing"] = {
        "replay_ms_per_policy": per_policy, "replay_plain_ms": replay_plain_ms,
        "replay_bytes": replay_bytes, "replay_ops": replay_ops,
        "replay_shape": [n_l, n_t, grid.key_space, grid.pad],
        "sim_ms": sim_ms, "sim_events": int(out.events.long().sum()),
        "sim_bytes": sim_bytes, "sim_ops": sim_ops,
        "sim_one_lane_ms": sim_one_lane_ms,
        "sim_one_lane_plain_ms": sim_one_plain_ms,
        "sim_one_lane_events": int(out_one.events.long().sum()),
        "sim_one_lane_bytes": one_bytes, "sim_one_lane_ops": one_ops,
        "traced_ms": traced_ms, "traced_plain_ms": traced_plain_ms,
        "ring_bytes": ring_bytes,
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
         "ms": sim_one_lane_ms, "plain_ms": sim_one_plain_ms,
         "bound_ms": sb, "bound_by": sby, "library_ms": None},
        {"name": "event_sim_traced", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/event_sim.cu",
         "replaces": "src/repro/kernels/event_sim.py:288",
         "ms": traced_ms, "plain_ms": traced_plain_ms,
         "bound_ms": tb, "bound_by": tby, "library_ms": None},
        {"name": "lru_batch_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cache_update.cu",
         "replaces": "src/repro/kernels/cache_update.py:34",
         "ms": lru["ms"], "plain_ms": lru["plain_ms"],
         "bound_ms": lb, "bound_by": lby, "library_ms": lru["library_ms"]},
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
    from repro_torch.kernels import cache_update as cu
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
    phases.run("trace_vs_plain", check_trace, rec)
    phases.run("lru_update_vs_plain", check_lru_update, rec)

    kr.replay_lanes.launches = 0
    es.sim_lanes.launches = 0
    phases.run("main_path", main_path, rec)
    launches = {"replay": kr.replay_lanes.launches,
                "event_sim": es.sim_lanes.launches}
    es.sim_lanes.traced_launches = 0
    phases.run("traced_path", traced_path, rec)
    launches["event_sim_traced"] = es.sim_lanes.traced_launches
    cu.lru_update.launches = 0
    phases.run("lru_update_path", lru_update_path, rec)
    launches["lru_batch_update"] = cu.lru_update.launches
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"its path never launched the {name} kernel")

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
