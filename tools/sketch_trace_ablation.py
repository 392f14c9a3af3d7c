"""Where the sketch_trace kernel's time goes, on the card.

    python3 tools/sketch_trace_ablation.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit (~2 min).  Builds one library from ``ABLATION_SRC``, which
includes ``src/repro_torch/kernels/csrc/sketch_trace.cu`` unchanged and
instantiates its kernel template ``sketch_trace_kernel<Table, kAhead,
kBatch>`` with other template arguments, one design step at a time:

* ``device_table``: the SpaceSaving table in device memory, searched by
  ``Lane::observe`` (three reductions), each block of 32 events loaded when
  the warp reaches it, every key ticked, its count-min and branch-row adds
  made per key: the design before the register table;
* ``registers_3``: the table in registers (``RegTable<S, false>``), three
  reductions a key;
* ``registers_1``: its packed form (``RegTable<S, true>``), one reduction;
* ``registers_1_ahead``: that with the next block of events fetched ahead;
* ``registers_1_ahead_batch``: that with no memory operation a key but the
  search's (kBatch: a block's count-min adds at once, the branch row from
  the done counter, a tick only where the window changes): the library's
  instantiation for these streams;
* ``registers_3_ahead_batch``: the unpacked form so (the library's for
  streams too long to pack);
* ``device_table_ahead_batch``: the device-memory table so (the library's
  S = 0, for caps over 512);
* ``floor`` and ``floor_batch``: timing only, the tick, count-min and EWMA
  steps with no SpaceSaving step (``NoSearch``, defined here alone), in the
  design before and in the library's; their states are not the plain
  version's.

Each runs fig_drift A's stream (``chip_smoke.fig_drift_stream``: 24 000
keys over 512, theta 0.9, an LRU cache's hits) at sketch_cap 96, 256 and
512 (S = 4, 8, 16), is held equal to the plain version
(``sketch_trace_plain`` on the CPU, every ``SketchState`` field) before its
time is printed, and is timed by CUDA events in turns with the others
(two rounds, five launches each).  Beside them: ``chip_smoke.py``'s probe
of a dependent chain of ``redux.sync`` minima (``redux_latency``: ns by
CUDA events, cycles by clock64), one warp reduction's latency, the unit of
the kernel's chain bound, whose ratio of cycles to ns turns each
variant's ns per key into cycles; and ``adds_kernel``, a lone warp's loop
of EWMA steps with one kind of add a step (atomic adds to device or
shared memory, by ``atomicAdd`` or PTX ``red``, plain shared-memory adds
and stores), in ns per step.  Prints one line per variant and writes
them, with each variant's registers, stack and local memory (``cuobjdump
-res-usage``) and the card's name and power limit, to
``chiprun_out/sketch_trace_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "sketch_trace_ablation"
CAPS = (96, 256, 512)
ROUNDS, REPS = 2, 5

ABLATION_SRC = r"""
#include "sketch_trace.cu"

namespace {

// timing only: the key count, no SpaceSaving step (the caller counts the
// count-min columns)
struct NoSearch {
  static constexpr bool kCountsMin = false;
  __device__ __forceinline__ void load(const sketch::Lane&) {}
  __device__ __forceinline__ void search(sketch::Lane& sk, int) { sk.key_count += 1; }
  __device__ __forceinline__ void store(const sketch::Lane&) const {}
};

template <class T, bool A, bool B>
int go(const SketchArgs& s, const int* keys, const float* t, const int* h,
       int lanes, int n, cudaStream_t st) {
  sketch_trace_kernel<T, A, B><<<lanes, 32, 0, st>>>(s, keys, t, h, n);
  return (int)cudaGetLastError();
}

template <int S>
int registers(int v, const SketchArgs& s, const int* keys, const float* t,
              const int* h, int lanes, int n, cudaStream_t st) {
  using R1 = sketch::RegTable<S, true>;
  using R3 = sketch::RegTable<S, false>;
  switch (v) {
    case 1: return go<R3, false, false>(s, keys, t, h, lanes, n, st);
    case 2: return go<R1, false, false>(s, keys, t, h, lanes, n, st);
    case 3: return go<R1, true, false>(s, keys, t, h, lanes, n, st);
    case 4: return go<R1, true, true>(s, keys, t, h, lanes, n, st);
    case 5: return go<R3, true, true>(s, keys, t, h, lanes, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// what one key's adds cost alone: a warp's loop of n steps, each an EWMA
// step and (KIND & 1) thread 0's RED to one address in device memory (the
// branch row's), (KIND & 2) threads 0-3's REDs to four rows' columns in
// device memory (the count-min rows'), (KIND & 4) those adds to rows in
// shared memory, (KIND & 8) thread 0's add to one shared address through
// a generic pointer (Lane::completion's to a staged branch row)
template <int KIND>
__global__ void __launch_bounds__(32) adds_kernel(int* buf, int width, int n,
                                                  int generic, float* out) {
  __shared__ int rows[sketch::CM_DEPTH * 513];
  const int me = threadIdx.x;
  for (int i = me; i < sketch::CM_DEPTH * 513; i += 32) rows[i] = 0;
  int* const one = generic ? rows : buf;  // known at run time alone
  __syncwarp();
  float s = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int col = (i * 37) & 511;
    if (KIND & 1) {
      if (me == 0) atomicAdd(&buf[0], 1);
    }
    if (KIND & 2) {
      if (me < sketch::CM_DEPTH) atomicAdd(&buf[1 + me * (width + 1) + col], 1);
    }
    if (KIND & 4) {
      if (me < sketch::CM_DEPTH) atomicAdd(&rows[me * 513 + col], 1);
    }
    if (KIND & 8) {
      if (me == 0) atomicAdd(one, 1);
    }
    if (KIND & 16) {
      if (me == 0) asm volatile("red.global.add.u32 [%0], 1;" ::"l"(buf) : "memory");
    }
    if (KIND & 32) {
      if (me < sketch::CM_DEPTH)
        asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(static_cast<unsigned>(
            __cvta_generic_to_shared(&rows[me * 513 + col]))) : "memory");
    }
    if (KIND & 64) {
      if (me < sketch::CM_DEPTH) rows[me * 513 + col] += 1;
    }
    if (KIND & 128) {
      if (me == (i & 31)) buf[1 + col] = i;
    }
    s = __fmaf_rn(s, 0.99f, (i & 1) ? 0.01f : 0.0f);
  }
  __syncwarp();
  if (me == 0) out[0] = s + static_cast<float>(rows[0] + rows[513]);
}

}  // namespace

extern "C" int adds_launch(int kind, int* buf, int width, int n, float* out,
                           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: adds_kernel<0><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 1: adds_kernel<1><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 2: adds_kernel<2><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 3: adds_kernel<3><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 4: adds_kernel<4><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 8: adds_kernel<8><<<1, 32, 0, st>>>(buf, width, n, 1, out); break;
    case 12: adds_kernel<12><<<1, 32, 0, st>>>(buf, width, n, 1, out); break;
    case 16: adds_kernel<16><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 32: adds_kernel<32><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 48: adds_kernel<48><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 64: adds_kernel<64><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    case 128: adds_kernel<128><<<1, 32, 0, st>>>(buf, width, n, 0, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ablation_launch(int v, int slots, const SketchArgs* s,
                               const int* keys, const float* t, const int* h,
                               int lanes, int n, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return go<GlobalTable, false, false>(*s, keys, t, h, lanes, n, st);
    case 6: return go<GlobalTable, true, true>(*s, keys, t, h, lanes, n, st);
    case 7: return go<NoSearch, false, false>(*s, keys, t, h, lanes, n, st);
    case 8: return go<NoSearch, true, true>(*s, keys, t, h, lanes, n, st);
  }
  switch (slots) {
    case 4: return registers<4>(v, *s, keys, t, h, lanes, n, st);
    case 8: return registers<8>(v, *s, keys, t, h, lanes, n, st);
    case 16: return registers<16>(v, *s, keys, t, h, lanes, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
# name -> the variant number of ablation_launch
VARIANTS = {"device_table": 0, "registers_3": 1, "registers_1": 2,
            "registers_1_ahead": 3, "registers_1_ahead_batch": 4,
            "registers_3_ahead_batch": 5, "device_table_ahead_batch": 6,
            "floor": 7, "floor_batch": 8}
TIMING_ONLY = ("floor", "floor_batch")
# adds_launch's kinds
ADDS = {"ewma": 0, "red_branch_row": 1, "red_count_min": 2,
        "red_both": 3, "shared_count_min": 4, "generic_shared_branch_row": 8,
        "shared_both": 12, "ptx_red_branch_row": 16,
        "ptx_red_shared_count_min": 32, "ptx_red_both": 48,
        "owner_shared_count_min": 64, "store": 128}


def build():
    """(ablation library, chase library, cuobjdump -res-usage by variant
    and S): the ablation source and chip_smoke's probes built at once."""
    from chip_smoke import build_chase
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "ablation.cu", OUT / "ablation.so"
    src.write_text(ABLATION_SRC)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared",
                             str(src), "-o", str(lib_path)],
                            stderr=subprocess.PIPE, text=True)
    chase = build_chase()
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the ablation library failed to build:\n{err}")
    lib = ctypes.CDLL(str(lib_path))
    lib.ablation_launch.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.ablation_launch.restype = ctypes.c_int
    lib.adds_launch.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    lib.adds_launch.restype = ctypes.c_int
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    usage, fn = {}, None
    for line in subprocess.run([tool, "-res-usage", str(lib_path)],
                               capture_output=True, text=True,
                               check=True).stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1) if "sketch_trace_kernel" in m.group(1) else None
            continue
        r = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if fn and r:
            usage[_variant_of(fn)] = dict(zip(
                ("registers", "stack_bytes", "local_bytes"),
                map(int, r.groups())))
            fn = None
    return lib, chase, usage


def _variant_of(mangled: str) -> str:
    """The variant name (with S) of a mangled sketch_trace_kernel."""
    args = mangled.split("sketch_trace_kernel", 1)[1]
    ahead, batch = (b == "1" for b in re.findall(r"Lb([01])E", args)[-2:])
    steps = ("_ahead" if ahead else "") + ("_batch" if batch else "")
    t = re.search(r"RegTableILi(\d+)ELb([01])E", mangled)
    if t:
        return (f"registers_{1 if t.group(2) == '1' else 3}{steps} "
                f"S={t.group(1)}")
    return ("floor" if "NoSearch" in mangled else "device_table") + steps


def launch(lib, variant: str, slots: int, keys, t, hits, cap: int, window):
    """One launch of ``variant`` on the (L, n) streams; returns the state."""
    import torch
    from repro_torch.kernels import sketch as ksk
    from repro_torch.kernels._build import check
    from repro_torch.obs.streaming import pow_table, sketch_init

    sk = sketch_init(cap, 1, keys.shape[0], device=keys.device)
    decay = pow_table(0, device=keys.device)
    args = ksk.sketch_args(sk, window, decay)
    check(lib.ablation_launch(VARIANTS[variant], slots, ctypes.byref(args),
                              keys.data_ptr(), t.data_ptr(), hits.data_ptr(),
                              keys.shape[0], keys.shape[1],
                              torch.cuda.current_stream().cuda_stream),
          f"sketch_trace {variant} launch")
    return sk


def adds_costs(lib, n: int, per_ns: float) -> dict:
    """ns per step of ``adds_launch``'s loops (n steps, count-min width
    768, fig_drift A's), by CUDA events."""
    import torch
    from chip_smoke import card_line, cuda_ms
    from repro_torch.kernels._build import check

    buf = torch.zeros(1 + 4 * 769, dtype=torch.int32, device="cuda")
    out = torch.zeros(1, dtype=torch.float32, device="cuda")
    card, res = card_line(), {}
    for name, kind in ADDS.items():
        ms = cuda_ms(lambda kind=kind: check(lib.adds_launch(
            kind, buf.data_ptr(), 768, n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "adds launch"), reps=5)
        ns = ms * 1e6 / n
        res[name] = {"ms": ms, "ns_per_step": ns, "cycles_per_step": ns * per_ns}
        print(f"{card}: {name}: {ns:.1f} ns ({ns * per_ns:.0f} cycles) per "
              f"step", flush=True)
    return res


def main() -> int:
    import torch
    from chip_smoke import (FD_WINDOW_US, card_line, cuda_ms,
                            fig_drift_stream, redux_latency)
    from repro_torch.kernels import sketch as ksk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    lib, chase, usage = build()
    red = redux_latency(chase)
    per_ns = red["cycles"] / red["ns"]  # the SM clock, cycles per ns
    print(f"{card}: one warp reduction (redux.sync.min and an add): "
          f"{red['ns']:.2f} ns, {red['cycles']:.1f} cycles", flush=True)
    keys, t, hits = fig_drift_stream(torch.device("cuda"))
    n = keys.shape[1]
    res = {"card": card, "redux": red, "keys": n, "usage": usage, "caps": {},
           "adds": adds_costs(lib, n, per_ns)}
    for cap in CAPS:
        slots = ksk.sketch_trace_form(cap, n)[0]
        plain = ksk.sketch_trace_plain(keys.cpu(), t.cpu(), hits.cpu(),
                                       sketch_cap=cap, window_us=FD_WINDOW_US)
        for name in VARIANTS:
            if name in TIMING_ONLY:
                continue
            got = launch(lib, name, slots, keys, t, hits, cap, FD_WINDOW_US)
            for f in got._fields:
                if not torch.equal(getattr(got, f).cpu(), getattr(plain, f)):
                    raise AssertionError(f"{name} at cap {cap} != plain: {f}")
        ms = {name: [] for name in VARIANTS}
        for _ in range(ROUNDS):
            for name in VARIANTS:
                ms[name].append(cuda_ms(lambda name=name: launch(
                    lib, name, slots, keys, t, hits, cap, FD_WINDOW_US),
                    reps=REPS))
        row = {}
        for name, runs in ms.items():
            ns = min(runs) * 1e6 / n
            row[name] = {"ms": runs, "ns_per_key": ns,
                         "cycles_per_key": ns * per_ns}
            print(f"{card}: cap {cap} (S={slots}), {name}: "
                  f"{' / '.join(f'{v:.3f}' for v in runs)} ms, {ns:.1f} ns "
                  f"({ns * per_ns:.0f} cycles) per key", flush=True)
        res["caps"][cap] = {"slots": slots, "variants": row,
                            "chain_bound_ms": n * red["ns"] * 1e-6}
    for name, v in sorted(usage.items()):
        print(f"registers {name}: {json.dumps(v)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sketch_trace_ablation.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
