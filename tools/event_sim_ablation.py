"""What each design choice of the event-sim kernel is worth, on the card.

    python3 tools/event_sim_ablation.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Builds ``src/repro_torch/kernels/csrc/event_sim.cu`` as it
is and copies with one choice undone (text substitutions; each copy
raises if its anchor is missing), each into its own library under
``build/event_sim_ablation/``:

* ``kernel``: the kernel as it is;
* ``cheap_draws``: the service laws replaced by one multiply (no log or
  pow): what the batched draws cost (its outputs are wrong by design);
* ``owner_branch``: job j's update under ``if (me == owner)``, a
  divergent branch, in place of the predicated update;
* ``handover_branch``: the successor's update under ``if (handover)``;
* ``ballot_busy``: the busy count by one ballot per register slot in
  place of ``__reduce_add_sync``;
* ``traced_stores_now``: the traced kernel storing each record and its
  stamps in the same event, not at the top of the next;
* ``traced_long_block``: the traced kernel compiling the block for routes
  over 32 visits into the common instantiation, behind ``if (n_l > 32)``.

The untraced copies run the main path's one-lane launch (the measured
LRU network at size 384, 16k requests, mpl 72); the traced ones the
LRU network's 21-lane grid at 100 us with 16384-record rings, beside the
untraced kernel on the same grid.  Each is timed by CUDA events, twice,
after one warm-up launch; every copy but ``cheap_draws`` must give the
kernel's completions, events and throughput, bit for bit.  Prints one
line per copy and writes them, with the card's name and power limit, to
``chiprun_out/event_sim_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "event_sim.cu"
OUT = ROOT / "build" / "event_sim_ablation"

CHEAP = (("    unit = -logf(u);", "    unit = u * 3.0f;"),
         ("    unit = w.lo * powf(1.0f - u * w.ratio, w.neg_inv) / w.raw;",
          "    unit = u * w.ratio;"))
OWNER = (("    {  // slot -1 outside j's owner", "    if (me == owner) {"),)
HANDOVER = (("    {\n      const uint32_t ready_w = clock",
             "    if (handover) {\n      const uint32_t ready_w = clock"),)
BALLOT = (("        __reduce_add_sync(FULL, lbusy) + (handover",
           "        ballot_count(jobs, k_next, j, me) + (handover"),
          ("template <int kTrace, int R>\n__global__",
           "template <class J>\n__device__ int ballot_count(J& jobs, int k,"
           " int j, int me) {\n  int n = 0;\n#pragma unroll\n"
           "  for (int r = 0; r < jobs.slots(); ++r)\n"
           "    n += __popc(__ballot_sync(FULL, jobs.enq(r) == BIG_SEQ &&"
           " jobs.st(r) == k && me + 32 * r != j));\n  return n;\n}\n\n"
           "template <int kTrace, int R>\n__global__"))
STORES_NOW = (("  while (completed < a.n_requests && events < max_events) {\n"
               "    store_trace();\n",
               "  while (completed < a.n_requests && events < max_events) {\n"),
              ("    events += 1;\n    ++slot;\n  }",
               "    events += 1;\n    ++slot;\n    store_trace();\n  }"))
LONG_BLOCK = (("      if constexpr (kTrace == 2) {", "      if (n_l > 32) {"),)
UNTRACED = {"kernel": (), "cheap_draws": CHEAP, "owner_branch": OWNER,
            "handover_branch": HANDOVER, "ballot_busy": BALLOT}
TRACED = {"traced": (), "traced_stores_now": STORES_NOW,
          "traced_long_block": LONG_BLOCK}


def build() -> dict:
    """Compile every copy at once, with the library's flags; returns
    name -> library."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    src, procs = SRC.read_text(), {}
    for name, subs in {**UNTRACED, **TRACED}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: anchor not found: {old!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", str(OUT / f"{name}.cu"), "-o",
             str(OUT / f"{name}.so")], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.event_sim_launch.argtypes = ([ctypes.c_void_p] * 13
                                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.event_sim_traced_launch.argtypes = (
            [ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.event_sim_launch.restype = ctypes.c_int
        lib.event_sim_traced_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, spec, seeds, kw):
    """A timed launch of ``lib``'s kernel on the lanes; returns (ms, outs)."""
    import torch
    from repro_torch.kernels._build import check
    from repro_torch.obs.trace import init_rings

    n_l, n_k = spec.is_queue.shape
    n_b, n_r = spec.visits.shape[1:]
    ins = [a.contiguous() for a in spec._replace(
        is_queue=spec.is_queue.to(torch.int32))] + [seeds, kw["max_events"]]
    cap = kw.get("trace_cap", 0)
    bmiss = kw["bmiss"].to(torch.int32).contiguous() if cap else None

    def launch():
        outs = [torch.empty(n_l, dtype=dt, device=seeds.device) for dt in
                (torch.float32, torch.int32, torch.int32, torch.float32)]
        dims = (n_l, n_k, n_b, n_r, kw["mpl"], kw["n_requests"], kw["warmup"])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        stream = torch.cuda.current_stream().cuda_stream
        rings = init_rings(n_l, cap, n_r, seeds.device) if cap else None
        torch.cuda.synchronize()
        start.record()
        if cap:
            err = lib.event_sim_traced_launch(
                *(a.data_ptr() for a in ins), bmiss.data_ptr(),
                *(a.data_ptr() for a in outs), *(a.data_ptr() for a in rings),
                *dims, cap, stream)
        else:
            err = lib.event_sim_launch(*(a.data_ptr() for a in ins),
                                       *(a.data_ptr() for a in outs), *dims,
                                       stream)
        end.record()
        torch.cuda.synchronize()
        check(err, "event-sim ablation launch")
        return start.elapsed_time(end), outs[:3]

    return launch


def main() -> int:
    import numpy as np
    import torch
    from chip_smoke import P_GRID, SEEDS, SIM_REQUESTS, TRACE_FULL, card_line
    from repro_torch.core.harness import measure_cache
    from repro_torch.core.policy_models import lru_network
    from repro_torch.core.simspec import compile_network
    from repro_torch.kernels import event_sim as es

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    libs = build()
    dev = torch.device("cuda")
    meas = measure_cache("lru", 384, key_space=4096, n_requests=60_000,
                         device="cuda")
    one = es.pad_lanes([compile_network(meas.network, meas.hit_ratio,
                                        device=dev)], [0], SIM_REQUESTS, 0.25)
    spec, seeds, kw_t = es.grid_lanes(
        lru_network(disk_us=100.0), np.asarray(P_GRID), SIM_REQUESTS, SEEDS,
        0.25, dev, trace=TRACE_FULL)
    kw = {k: v for k, v in kw_t.items() if k not in ("trace_cap", "bmiss")}
    runs = [(name, "1 lane", launcher(libs[name], *one)) for name in UNTRACED]
    runs.append(("kernel", "21 lanes", launcher(libs["kernel"], spec, seeds, kw)))
    runs += [(name, "21 lanes traced", launcher(libs[name], spec, seeds, kw_t))
             for name in TRACED]
    res, want = {"card": card}, {}
    for name, shape, launch in runs:
        launch()  # warm-up
        (ms1, outs), (ms2, _) = launch(), launch()
        events = int(outs[2].max())
        key = shape.replace(" traced", "")
        if name != "cheap_draws":
            ref = want.setdefault(key, outs)
            if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                raise AssertionError(f"{name} changed the simulation")
        res[f"{name}, {shape}"] = {"ms": [ms1, ms2], "events": events,
                                   "ns_per_event": 1e6 * min(ms1, ms2) / events}
        print(f"{card}: {name}, {shape}: {ms1:.3f} / {ms2:.3f} ms, "
              f"{1e6 * min(ms1, ms2) / events:.1f} ns per event", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "event_sim_ablation.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
