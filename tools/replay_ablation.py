"""What each design choice of the replay kernel is worth, on the card.

    python3 tools/replay_ablation.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Measures:

* ``chase``: the latency of one dependent load, by ``chip_smoke.py``'s
  one-thread pointer chase over a random cycle of 1 024 ints in shared
  memory (the replay chain's unit, which ``chip_smoke.py`` multiplies
  into the replay kernel's bound) and in device memory (L1-resident
  after the first lap);
* the replay kernel beside copies of ``src/repro_torch/kernels/csrc/
  replay.cu`` with one choice undone (text substitutions; each copy raises
  if its anchor is missing), each built into its own library under
  ``build/replay_ablation/``:

  - ``kernel``: the kernel as it is;
  - ``leader_io``: the leader loads each request's key, coin and window
    and stores its four outputs itself, in place of the warp's batches
    of 32 staged through shared memory;
  - ``int32_links``: int32 links and key2slot in the shared-memory layout;
  - ``global``: the kernel's own device-memory layout (per-key tables and
    slot arrays in device memory, int32 links) at key space 4096, where
    shared memory holds them.

The copies run the 1-lane LRU and SIEVE launches of the main path's
longest chain: capacity 96, key space 4096, pad 3300, window 8, 60k
requests of ``zipf_trace(60_000, 4096, 0.99, 0)``.  Each is timed by CUDA
events, twice, after one warm-up launch, and must equal the kernel's
outputs bit for bit.  Prints one line per copy and writes them, with the
card's name and power limit, to ``chiprun_out/replay_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "replay.cu"
OUT = ROOT / "build" / "replay_ablation"

LEADER_IO = ((
    "  // a batch ahead, in registers: request base + lane",
    """  if (lane == 0) {
    for (int t = 0; t < n_t; ++t) {
      const int key = keys[row + t];
      const int e = L.exp[key];
      const Out o = L.step(key, us[row + t], n1);
      const bool outstanding = t <= e;
      if (!outstanding && !o.hit) L.exp[key] = t + wins[row + t];
      hits[row + t] = o.hit;
      evicted[row + t] = o.evicted;
      ops[row + t] = o.delink | (o.head << 1) | (o.tail << 9) | (o.scan << 12);
      cls[row + t] = outstanding ? 2 : (o.hit ? 1 : 0);
    }
  }
  return;
  // a batch ahead, in registers: request base + lane"""),)
INT32_LINKS = (
    ("using Link = std::conditional_t<LAYOUT == ALL_GLOBAL, int, int16_t>;",
     "using Link = int;"),
    ("  return layout == ALL_GLOBAL ? 4 : 2;", "  return 4;"),
)
COPIES = {"kernel": (), "leader_io": LEADER_IO, "int32_links": INT32_LINKS}


def build() -> dict:
    """Compile every copy at once, with the library's flags, and the chase
    meanwhile; returns name -> library."""
    from chip_smoke import build_chase
    from repro_torch.kernels._build import NVCC_FLAGS, _SIGNATURES, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    src = SRC.read_text()
    for name, subs in COPIES.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: anchor not found: {old!r}")
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", str(OUT / f"{name}.cu"), "-o",
             str(OUT / f"{name}.so")], stderr=subprocess.PIPE, text=True)
    libs = {"chase": build_chase()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ("replay_launch", "replay_bytes"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = \
                _SIGNATURES[fn]
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from chip_smoke import POLICY_PARAMS, card_line, load_latency
    from repro_torch.core.harness import coin_stream, zipf_trace
    from repro_torch.kernels import replay as kr

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    libs = build()
    res = {"card": card, "chase": load_latency(libs["chase"])}
    for where, v in res["chase"].items():
        print(f"{card}: dependent load ({where} memory): {v['ns']:.2f} ns, "
              f"{v['cycles']:.1f} cycles", flush=True)
    trace, us = zipf_trace(60_000, 4096, 0.99, 0), coin_stream(60_000, 0)
    for policy in ("lru", "sieve"):
        grid = kr.grid_lanes(policy, trace, us, [96], key_space=4096,
                             pad_to=3300, window=8, device="cuda",
                             **POLICY_PARAMS[policy])
        shared = kr.layout_bytes(policy, 4096, 3300, "shared")
        runs = [(name, libs[name], shared) for name in COPIES]
        runs.append(("global", libs["kernel"],
                     kr.layout_bytes(policy, 4096, 3300, "global")))
        want = None
        for name, lib, layout in runs:
            def launch():
                return kr._launch(lib, policy, layout, grid.args,
                                  grid.key_space, grid.pad)
            launch()  # warm-up
            ms = []
            for _ in range(2):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                outs = launch()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            want = want or outs
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise AssertionError(f"{policy} {name} changed the replay")
            n_t = grid.args[2].shape[1]
            res[f"{policy}, {name}"] = {
                "ms": ms, "requests": n_t,
                "ns_per_request": 1e6 * min(ms) / n_t}
            print(f"{card}: {policy} 1 lane (capacity 96), {name}: "
                  f"{ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"{1e6 * min(ms) / n_t:.1f} ns per request", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "replay_ablation.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
