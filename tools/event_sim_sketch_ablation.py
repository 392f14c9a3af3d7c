"""Where the streaming sketch's time goes in the event-sim kernel, on the card.

    python3 tools/event_sim_sketch_ablation.py [--rounds N] [--reps N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit (~3 min with the build), in a call of its own (not inside
``chip_smoke.py``'s time limit).  Builds one library from a source that
includes ``src/repro_torch/kernels/csrc/event_sim.cuh`` unchanged and
instantiates its kernel template with other sketch policies, one design
step at a time (the ``L`` of ``Sketched<Ext, L>``; the levers of the
library's ``sketch::SimLane`` defined here, in ``ABLATION_SRC``, where the
library has one form):

* ``before``: ``sketch::Lane`` in place, the design of the sketch slice
  and the library's for the closed, counting and traced closed modes: at
  the reference's sites, in the event: the tick after the argmin (its
  window change inline), thread 0's RED to the branch row per completion
  after a shuffle of the branch and a shared-memory read of its miss
  class, per woken job a RED, per observed key threads 0-3's count-min
  REDs and the SpaceSaving search in device memory (three reductions, the
  owner's stores);
* ``in_place_branch_registers``, ``in_place_count_min_batch``,
  ``in_place_table_registers``: ``before`` with one lever each
  (``InPlace``): the window's completions per branch in registers, added
  to the row when the ring leaves the window; a block of 32 keys'
  count-min adds made at once; the table in registers, packed, one
  reduction a key (``sketch::RegTable<1, true>``); ``in_place_all``: the
  three together;
* ``logged``: ``sketch::SimLane<>``, the library's for the coalescing,
  open-loop and tiered modes: every event logs its record in registers
  and the sketch replays the log outside the event loop every 32 events,
  with the first two levers and the table in device memory;
  ``logged_count_min_each``: that with threads 0-3's count-min REDs per
  key (``CmEach``); ``logged_table_registers`` and
  ``logged_table_registers_unpacked``: that with the table in registers,
  packed (one reduction a key) and not (three);
* ``floor``: timing only, ``logged`` with a table that observes nothing
  (no count-min, no search); ``carry_live``: ``logged`` with a replay
  that only folds each record into one register (what logging costs the
  loop); ``carry``: ``logged`` with its log never replayed (the compiler
  drops the log too); ``unsketched``: the unsketched kernel built in this
  library (as the library's ``off``).

Each runs four lanes of ``chip_smoke.py``'s ``ext_timing``, 1 500 requests
each: fig_drift D's closed lane (LRU, 100 us disk, p 0.55, sketch_cap 8),
the coalescing lane (fig_delayed_hits B, 16 flows), the open loop
(fig_latency C) and the tiered lane (fig_hierarchy), sketch_cap 16 on
the last three, 1 ms windows.  Before any time is printed every variant
but the timing-only ones is held: on each lane, every sketch field and every
simulation output identical to ``before``'s; on each lane made
deterministic (``chip_smoke.det_network``), every sketch field identical
to the plain version's (``sim_lanes`` on the CPU) and every simulation
output to the unsketched kernel's.  Then every variant and the library's
unsketched kernel (``off``) are timed on each lane by CUDA events, in
turns (``--rounds`` rounds of ``--reps`` launches; ``chip_smoke.
device_ms``: the launches queued behind a sleep kernel, so that the
host's cost per launch is not counted); the fastest round gives ns per
event and the sketch's added ns per event, and the rounds' spread is
printed beside it.  Prints one line per lane and variant with the card's
name and power limit, and writes them, with each variant's registers,
stack and local memory (``cuobjdump -res-usage``), to
``chiprun_out/event_sim_sketch_ablation.json``; the SASS of the closed and
coalescing lanes' instantiations of ``SASS_VARIANTS`` to
``chiprun_out/event_sim_sketch_ablation.sass``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "event_sim_sketch_ablation"

ABLATION_SRC = r"""
#include "event_sim.cuh"

namespace {

using sketch::DeviceTable;
using sketch::RegTable;
using sketch::SimLane;

// the design before (sketch::Lane, in place) with SimLane's levers: kBr
// the window's completions per branch in registers (branch b in thread b,
// added to the row when the ring leaves the window and at the end; past
// 32 thread 0's add), kCm a block of 32 keys' count-min adds at once,
// Table the SpaceSaving table
template <bool kBr, bool kCm, class Table>
struct InPlace : sketch::Lane {
  Table tab;
  int br_n, cm_key, cm_n;

  __device__ __forceinline__ void init(const SketchArgs& s, int lane, int thread) {
    sketch::Lane::init(s, lane, thread);
    tab.load(*this);
    br_n = cm_key = cm_n = 0;
  }
  __device__ __forceinline__ void flush_branch() {
    if (br_n != 0 && me < B) atomicAdd(&br[slot * B + me], br_n);
    br_n = 0;
  }
  __device__ __forceinline__ void tick(float elapsed_us) {
    int w;
    if (leaves_window(elapsed_us, w)) {
      if constexpr (kBr) flush_branch();
      enter_window(w);
    }
  }
  __device__ __forceinline__ void completion(int b, bool is_hit, bool delayed) {
    if constexpr (kBr) {
      c_done += 1;
      c_hit += is_hit ? 1 : 0;
      c_dly += delayed ? 1 : 0;
      if (b == me && b < B) br_n += 1;
      if (b >= 32 && b < B && me == 0) atomicAdd(&br[slot * B + b], 1);
      s_hit = __fmaf_rn(s_hit, one_minus, is_hit ? alpha : 0.0f);
      s_dly = __fmaf_rn(s_dly, one_minus, delayed ? alpha : 0.0f);
      s_norm = __fmul_rn(s_norm, one_minus);
    } else {
      sketch::Lane::completion(b, is_hit, delayed);
    }
  }
  __device__ __forceinline__ void flush_cm() {
    if (me < cm_n) {
#pragma unroll
      for (int r = 0; r < sketch::CM_DEPTH; ++r)
        atomicAdd(&cm[sketch::cm_offset(cm_key, r, width)], 1);
    }
    cm_n = 0;
  }
  __device__ __forceinline__ void observe(int k) {
    if constexpr (kCm) {
      if (me == cm_n) cm_key = k;
      if (++cm_n == 32) flush_cm();
    } else {
      sketch::cm_add(cm, width, me, k);
    }
    tab.search(*this, k);
  }
  __device__ __forceinline__ void finish(const SketchArgs& s, int lane) {
    if constexpr (kBr) flush_branch();
    flush_cm();
    tab.store(*this);
    sketch::Lane::finish(s, lane);
  }
};

// the count-min adds per key, threads 0-3's REDs (Lane::observe's), and
// the table in device memory
struct CmEach {
  static constexpr bool kCountsMin = true;
  __device__ __forceinline__ void load(const sketch::Lane&) {}
  __device__ __forceinline__ void search(sketch::Lane& sk, int k) {
    sketch::cm_add(sk.cm, sk.width, sk.me, k);
    sk.search(k);
  }
  __device__ __forceinline__ void store(const sketch::Lane&) const {}
};

// timing only: a table that observes nothing (no count-min, no search)
struct NoKeys {
  static constexpr bool kCountsMin = true;
  __device__ __forceinline__ void load(const sketch::Lane&) {}
  __device__ __forceinline__ void search(sketch::Lane&, int) {}
  __device__ __forceinline__ void store(const sketch::Lane&) const {}
};

// timing only: L's events logged and replayed by a fold of their records
// (what logging costs the loop)
template <class L>
struct CarryLive : L {
  __device__ __forceinline__ void replay_block(bool in, float rt, int ra, int rk,
                                               int rw, const int*) {
    this->key_count += in ? ra + rk + rw + __float_as_int(rt) : 0;
  }
};

// timing only: L's events logged and never replayed
template <class L>
struct Carry : L {
  __device__ __forceinline__ void replay_block(bool, float, int, int, int,
                                               const int*) {}
};

// the lanes' register slots: one instantiation of each mode
constexpr int R_CLOSED = {r_closed}, R_FLOWS = {r_flows}, R_OPEN = {r_open},
              R_TIERS = {r_tiers};

// the lane's mode at its register slots, parameters ex (kTiers: tx)
template <class E, class TE>
int go_with(const ExtArgs& p, const E& ex, const TE& tx, void* stream) {
  const Args a = args_of(p);
  const Rings none{};
  const int r = reg_slots(p.mpl);
  if (p.cap > 0) return (int)cudaErrorInvalidValue;
  switch (ext_mode(p)) {
    case kClosed:
      if (r != R_CLOSED) return (int)cudaErrorInvalidValue;
      return launch_slots<0, R_CLOSED, kClosed>(a, none, p.lanes, stream, ex);
    case kFlows:
      if (r != R_FLOWS) return (int)cudaErrorInvalidValue;
      return launch_slots<0, R_FLOWS, kFlows>(a, none, p.lanes, stream, ex);
    case kOpen:
      if (r != R_OPEN) return (int)cudaErrorInvalidValue;
      return launch_slots<0, R_OPEN, kOpen>(a, none, p.lanes, stream, ex);
    case kTiers:
      if (r != R_TIERS) return (int)cudaErrorInvalidValue;
      return launch_slots<0, R_TIERS, kTiers>(a, none, p.lanes, stream, tx);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class L>
int go(const ExtArgs& p, const SketchArgs& s, void* stream) {
  return go_with(p, sketched_ext<L>(p, s), sketched_tiers<L>(p, s), stream);
}

}  // namespace

extern "C" int ablation_launch(int v, const ExtArgs* p, const SketchArgs* s,
                               void* stream) {
  using RP = RegTable<1, true>;
  using RU = RegTable<1, false>;
  switch (v) {
    case 0: return go<sketch::Lane>(*p, *s, stream);
    case 1: return go<InPlace<true, false, DeviceTable>>(*p, *s, stream);
    case 2: return go<InPlace<false, true, DeviceTable>>(*p, *s, stream);
    case 3: return go<InPlace<false, false, RP>>(*p, *s, stream);
    case 4: return go<InPlace<true, true, RP>>(*p, *s, stream);
    case 5: return go<SimLane<>>(*p, *s, stream);
    case 6: return go<SimLane<CmEach>>(*p, *s, stream);
    case 7: return go<SimLane<RP>>(*p, *s, stream);
    case 8: return go<SimLane<RU>>(*p, *s, stream);
    case 9: return go<SimLane<NoKeys>>(*p, *s, stream);
    case 10: return go<CarryLive<SimLane<>>>(*p, *s, stream);
    case 11: return go<Carry<SimLane<>>>(*p, *s, stream);
    case 12: return go_with(*p, ext_of(*p), tiers_of<TierExt>(*p), stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
# name -> the variant number of ablation_launch
VARIANTS = {"before": 0, "in_place_branch_registers": 1,
            "in_place_count_min_batch": 2, "in_place_table_registers": 3,
            "in_place_all": 4, "logged": 5, "logged_count_min_each": 6,
            "logged_table_registers": 7,
            "logged_table_registers_unpacked": 8, "floor": 9,
            "carry_live": 10, "carry": 11, "unsketched": 12}
TIMING_ONLY = ("floor", "carry", "unsketched", "carry_live")
# the SASS of these variants' closed and coalescing instantiations is
# written out
SASS_VARIANTS = ("before", "logged", "carry", "unsketched")
# InPlace<kBr, kCm, Table>'s variants, by (kBr, kCm, table in registers)
IN_PLACE = {(True, False, False): "in_place_branch_registers",
            (False, True, False): "in_place_count_min_batch",
            (False, False, True): "in_place_table_registers",
            (True, True, True): "in_place_all"}
MODES = ("closed", "coalescing", "open loop", "tiered")


def lanes(dev, det=False):
    """{name: (launch, spec, seeds, kwargs, sketch kwargs)} of the timed
    lanes (made deterministic with ``det``); ``launch(spec, seeds,
    **kwargs, **sketch kwargs)`` runs the lane's sketched kernel."""
    import dataclasses

    import numpy as np
    from chip_smoke import (DH_DISK_US, DH_IO_DEPTH, EXT_TIMING_REQUESTS, FD_P,
                            HI_MPL, LAT_CO_FLOWS, LAT_CO_IO_DEPTH,
                            LAT_CO_LAMBDA, LAT_DISK_US, det_network)
    from repro_torch.core import build
    from repro_torch.kernels import event_sim as es
    from test_torch_event_sim_cuda import hierarchy_model

    n = EXT_TIMING_REQUESTS
    twin = det_network if det else (lambda net: net)
    out = {}

    def grid(name, net, p, cap, **kw):
        out[name] = (es.sim_lanes, *es.grid_lanes(
            twin(net), np.array([p]), n, (0,), 0.25, dev, sketch=True, **kw),
            dict(sketch_cap=cap, window_us=1_000.0))

    grid("closed", build("lru", disk_us=100.0), FD_P[0], 8)
    grid("coalescing", build("lru", disk_us=DH_DISK_US,
                             disk_servers=DH_IO_DEPTH), 0.5, 16,
         coalesce_flows=16)
    net_c = build("lru", disk_us=LAT_DISK_US, disk_servers=LAT_CO_IO_DEPTH)
    net_c = twin(dataclasses.replace(net_c, stations=tuple(
        dataclasses.replace(st, dist="det") if st.name == "disk" else st
        for st in net_c.stations)))
    ospec, oseeds, okw = es.open_lanes(
        net_c, np.array([0.5]), np.array([LAT_CO_LAMBDA]), n, (0,), 0.25, 256,
        coalesce_flows=LAT_CO_FLOWS, device=dev)
    del okw["sketch_cap"], okw["window_us"]  # off: 0
    out["open loop"] = (es.sim_open_lanes, ospec, oseeds, okw,
                        dict(sketch_cap=16, window_us=1_000.0))
    hm = hierarchy_model("fig", HI_MPL)
    grid("tiered", hm.network, 0.5 * sum(hm.profile.p_range()), 16,
         coalesce_flows=4, tiers=hm.mshr)
    return out


def to_cpu(x):
    """Tensors, tuples of them and dicts of them, on the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(to_cpu, x))
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


class Shim:
    """The kernel library as ``_launch_ext`` calls it, with the event-sim
    launch routed to ``ablation_launch(variant, ...)``."""

    def __init__(self, real, lib, variant):
        self.real, self.lib, self.variant = real, lib, variant

    def event_sim_ext_shared_bytes(self, a, sketched):
        return self.real.event_sim_ext_shared_bytes(a, sketched)

    def event_sim_ext_launch(self, a, s, stream):
        return self.lib.ablation_launch(self.variant, a, s, stream)


def build(slots: dict):
    """(ablation library, cuobjdump -res-usage by variant and mode)."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "ablation.cu", OUT / "ablation.so"
    text = ABLATION_SRC
    for key, r in slots.items():
        text = text.replace("{" + key + "}", str(r))
    src.write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared",
                           str(src), "-o", str(lib_path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the ablation library failed to build:\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.ablation_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.ablation_launch.restype = ctypes.c_int
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    usage, fn = {}, None
    for line in subprocess.run([tool, "-res-usage", str(lib_path)],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = _name_of(m.group(1)) if "sim_kernel" in m.group(1) else None
            continue
        r = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if fn and r:
            usage[fn] = dict(zip(("registers", "stack_bytes", "local_bytes"),
                                 map(int, r.groups())))
            fn = None
    keep, out = False, []
    for line in subprocess.run([tool, "-sass", str(lib_path)],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _name_of(m.group(1)) if "sim_kernel" in m.group(1) else ""
            keep = name in {f"{v} {m}" for v in SASS_VARIANTS
                            for m in ("closed", "coalescing")}
            if keep:
                out.append(f"// {name}")
        if keep:
            out.append(line)
    sass = ROOT / "chiprun_out" / "event_sim_sketch_ablation.sass"
    sass.parent.mkdir(exist_ok=True)
    sass.write_text("\n".join(out) + "\n")
    return lib, usage


def _name_of(mangled: str) -> str:
    """'<variant> <mode>' of a mangled sim_kernel instantiation."""
    mode = MODES[(0, 1, 2, None, 3)[int(
        re.search(r"sim_kernelILi0ELi\d+ELi(\d)E", mangled).group(1))]]
    in_place = re.search(r"InPlaceILb([01])ELb([01])E", mangled)
    if "CarryLive" in mangled:
        name = "carry_live"
    elif "Carry" in mangled:
        name = "carry"
    elif "NoKeys" in mangled:
        name = "floor"
    elif "CmEach" in mangled:
        name = "logged_count_min_each"
    elif in_place:
        name = IN_PLACE[(in_place.group(1) == "1", in_place.group(2) == "1",
                         "RegTable" in mangled)]
    elif "SimLane" in mangled:
        table = re.search(r"RegTableILi1ELb([01])E", mangled)
        name = ("logged" if table is None else "logged_table_registers"
                + ("" if table.group(1) == "1" else "_unpacked"))
    elif "Sketched" in mangled:
        name = "before"
    else:
        name = "unsketched"
    return f"{name} {mode}"


def main() -> int:
    import torch
    from chip_smoke import card_line, device_ms
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda")
    real = _build.load_library()
    timed, twins = lanes(dev), lanes(dev, det=True)
    slots = {f"r_{k}": real.event_sim_slots(
        lane[3].get("mpl", lane[3].get("n_slots"))) for k, lane in zip(
        ("closed", "flows", "open", "tiers"), timed.values())}
    lib, usage = build(slots)

    def run(variant, lane):
        call, spec, seeds, kw, sk = lane
        with mock.patch.object(_build, "load_library",
                               lambda: Shim(real, lib, VARIANTS[variant])):
            return call(spec, seeds, **kw, **sk)

    def off(lane):  # the library's unsketched kernel
        call, spec, seeds, kw, _ = lane
        return call(spec, seeds, **kw)

    def same(a, b, what):
        for f, x in a._asdict().items():
            y = getattr(b, f)
            if x is None and y is None:
                continue
            for fx, fy in zip(x, y) if f == "sketch" else ((x, y),):
                if not torch.equal(fx.cpu(), fy.cpu()):
                    raise AssertionError(f"{what}: {f}")

    held = [v for v in VARIANTS if v not in TIMING_ONLY]
    for mode in MODES:
        base = run("before", timed[mode])
        for v in held:
            same(run(v, timed[mode]), base, f"{v} != before on the {mode} lane")
        call, spec, seeds, kw, sk = twins[mode]
        # the plain version: the lane's tensors on the CPU
        plain = call(to_cpu(spec), to_cpu(seeds), **to_cpu(kw), **sk)
        bare = off(twins[mode])
        for v in held:
            got = run(v, twins[mode])
            for f in got.sketch._fields:
                if not torch.equal(getattr(got.sketch, f).cpu(),
                                   getattr(plain.sketch, f)):
                    raise AssertionError(f"{v} != plain on the deterministic "
                                         f"{mode} lane: sketch {f}")
            for f, x in got._asdict().items():
                if f != "sketch" and x is not None and not torch.equal(
                        x, getattr(bare, f)):
                    raise AssertionError(f"{v} != the unsketched kernel on "
                                         f"the deterministic {mode} lane: {f}")
        print(f"{card}: {mode} lane: every variant but the floor == before "
              f"(every field); on the deterministic lane == plain (every "
              f"sketch field) and the unsketched kernel (every output)",
              flush=True)
    res = {"card": card, "usage": usage, "lanes": {}}
    for mode in MODES:
        lane = timed[mode]
        events = int(off(lane).events.long().sum())
        ms = {name: [] for name in ("off",) + tuple(VARIANTS)}
        for _ in range(args.rounds):
            ms["off"].append(device_ms(lambda: off(lane), reps=args.reps))
            for v in VARIANTS:
                ms[v].append(device_ms(lambda v=v: run(v, lane),
                                       reps=args.reps))
        off_ns = min(ms["off"]) * 1e6 / events
        row = {}
        for name, runs in ms.items():
            ns = min(runs) * 1e6 / events
            spread = (max(runs) - min(runs)) * 1e6 / events
            row[name] = {"ms": runs, "ns_per_event": ns,
                         "added_ns_per_event": ns - off_ns,
                         "spread_ns_per_event": spread}
            print(f"{card}: {mode} lane ({events} events), {name}: "
                  f"{' / '.join(f'{v:.4f}' for v in runs)} ms, {ns:.1f} ns "
                  f"per event ({ns - off_ns:+.1f} over off; rounds spread "
                  f"{spread:.1f})", flush=True)
        res["lanes"][mode] = {"events": events, "variants": row}
    for name, v in sorted(usage.items()):
        print(f"registers {name}: {json.dumps(v)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "event_sim_sketch_ablation.json").write_text(
        json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    sys.exit(main())
