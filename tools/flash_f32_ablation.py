"""What each design choice of the split-TF32 flash kernel is worth, on the card.

    python3 tools/flash_f32_ablation.py [--baseline OLD/flash_attention.cu]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Builds ``src/repro_torch/kernels/csrc/flash_attention.cu``
as it is and copies with one choice changed (by text substitutions in the
file with ``tf32_mma.cuh`` pasted in place of its ``#include``, each of
which raises unless its anchor occurs once), each into its own library under
``build/flash_f32_ablation/`` (all compiled at once, ``-Xptxas -v``: the
float32 d_head 128 instantiation's registers and spills are printed, and
its instructions counted by opcode from ``cuobjdump``):

* ``kernel``: the library's build (split TF32 paid in registers by
  integer operations, 128-row q tiles of 8 warps, 64-column K/V tiles in
  two ``cp.async`` stages, the longest q tiles first, each warp skipping
  the tiles masked for its rows);
* ``plain_tf32``: each product in plain TF32, one ``mma`` (never on a
  path: its max error is printed beside its time);
* ``rna_split``: hi and lo each rounded by ``cvt.rna.tf32.f32`` in place
  of ``split_frag``'s integer operations;
* ``smem_split``: each K/V tile split once into hi/lo tiles in shared
  memory, in place of splitting each fragment as it is read; the hi/lo
  tiles fit beside the q tile only at 32 columns, so compare it with
  ``bk32``;
* ``sync_copies``: each tile's copy waited for as soon as issued, in place
  of overlapping this tile's products;
* ``bk32``: 32-column K/V tiles in place of 64;
* ``warps4``: 64-row q tiles of 4 warps in place of 128 rows of 8;
* ``short_first``: the q tiles launched from the first (the shortest under
  a causal mask) in place of from the last;
* ``no_warp_skip``: every warp computes every tile its block visits;
* cut-outs, whose outputs are wrong by design: ``no_qk`` (the q K^T
  products and their fragments) and ``no_pv`` (the P V products and
  theirs);
* ``baseline``: with ``--baseline``, another source of the same interface
  (an earlier version, unpacked with ``git show
  <commit>:src/repro_torch/kernels/csrc/flash_attention.cu`` into the
  ignored ``build/``), built with its own defaults.

Every variant runs at the prefill path's shape of ``chip_smoke.py`` (B 4,
T = S = 2 048, 16 query heads and 8 KV heads of 128, float32, causal),
with no window and with a 1 024-token window, timed by CUDA events over 20
launches after one warm-up, in two rounds, the second in the reverse
order.  Each variant's output is held against the plain version: the max
|d| is printed, and whether it is within the reference's float32
tolerance (2e-5, relative and absolute), which the library's kernel must
be.  Prints one JSON line per variant and writes them, with the card's
name and power limit, to ``chiprun_out/flash_f32_ablation.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
HEADER = SRC.parent / "tf32_mma.cuh"
OUT = ROOT / "build" / "flash_f32_ablation"
SHAPE = (4, 2048, 2048, 16, 8, 128)  # B, T, S, H, KV, dh: chip_smoke.FLASH_FULL
WINDOWS = (0, 1024)
TOL = 2e-5  # tests/test_kernels.py::_tol, float32
# text substitutions (old, new); each copy raises unless its anchor occurs once
PLAIN_TF32 = ("#define TF32_SPLIT 1", "#define TF32_SPLIT 0")
RNA = ("f.hi[e] = (__float_as_uint(x[e]) + 0x1000u) & 0xffffe000u;\n"
       "      f.lo[e] = TF32_SPLIT ? __float_as_uint(x[e] - __uint_as_float(f.hi[e])) : 0u;",
       'asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(f.hi[e]) : "f"(x[e]));\n'
       '      asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(f.lo[e]) '
       ': "f"(x[e] - __uint_as_float(f.hi[e])));')
# smem_split: float32 K/V tiles split once, in place, into hi tiles and lo
# tiles beside the two stages, and the fragments read from them
SMEM_BYTES = ("BYTES = Q_BYTES + 2 * (K_BYTES + V_BYTES);",
              "BYTES = Q_BYTES + 2 * (K_BYTES + V_BYTES) + (EXACT ? 0 : K_BYTES + V_BYTES);")
SMEM_LO = ("  T* sv0 = reinterpret_cast<T*>(smem + L::Q_BYTES + 2 * L::K_BYTES);\n",
           "  T* sv0 = reinterpret_cast<T*>(smem + L::Q_BYTES + 2 * L::K_BYTES);\n"
           "  uint32_t* klo = reinterpret_cast<uint32_t*>(\n"
           "      smem + L::Q_BYTES + 2 * (L::K_BYTES + L::V_BYTES));\n"
           "  uint32_t* vlo = klo + BK * SK;\n")
SMEM_SPLIT_TILES = (
    "    // A tile masked for all the warp's rows",
    "    if constexpr (!EXACT) {\n"
    "      uint32_t* khi = reinterpret_cast<uint32_t*>(sk);\n"
    "      uint32_t* vhi = reinterpret_cast<uint32_t*>(sv);\n"
    "      for (int e = threadIdx.x; e < BK * SK; e += THREADS) {\n"
    "        const float x[1] = {__uint_as_float(khi[e])};\n"
    "        const Frag<1> f = split_frag<false>(x);\n"
    "        khi[e] = f.hi[0];\n"
    "        klo[e] = f.lo[0];\n"
    "      }\n"
    "      for (int e = threadIdx.x; e < BK * SV; e += THREADS) {\n"
    "        const float x[1] = {__uint_as_float(vhi[e])};\n"
    "        const Frag<1> f = split_frag<false>(x);\n"
    "        vhi[e] = f.hi[0];\n"
    "        vlo[e] = f.lo[0];\n"
    "      }\n"
    "      __syncthreads();\n"
    "    }\n"
    "    // A tile masked for all the warp's rows")
SMEM_K = (
    "          const float2 y = ld_pair(sk + (8 * j + g) * SK + 8 * kk + 2 * t);\n"
    "          const float kv[2] = {y.x, y.y};\n"
    "          mma_split<false, EXACT>(s[j], slo[j], fa, split_frag<EXACT>(kv));",
    "          const int at = (8 * j + g) * SK + 8 * kk + 2 * t;\n"
    "          Frag<2> fb;\n"
    "          if constexpr (!EXACT) {\n"
    "            const uint2 hi = *reinterpret_cast<const uint2*>(\n"
    "                reinterpret_cast<const uint32_t*>(sk) + at);\n"
    "            const uint2 lo = *reinterpret_cast<const uint2*>(klo + at);\n"
    "            fb = {{hi.x, hi.y}, {lo.x, lo.y}};\n"
    "          } else {\n"
    "            const float2 y = ld_pair(sk + at);\n"
    "            const float kv[2] = {y.x, y.y};\n"
    "            fb = split_frag<EXACT>(kv);\n"
    "          }\n"
    "          mma_split<false, EXACT>(s[j], slo[j], fa, fb);")
SMEM_V = (
    "          const float vv[2] = {to_f32(sv[at]), to_f32(sv[at + SV])};\n"
    "          mma_split<false, EXACT>(o[n], o[n], pf[j], split_frag<EXACT>(vv));",
    "          Frag<2> fb;\n"
    "          if constexpr (!EXACT) {\n"
    "            const uint32_t* vhi = reinterpret_cast<const uint32_t*>(sv);\n"
    "            fb = {{vhi[at], vhi[at + SV]}, {vlo[at], vlo[at + SV]}};\n"
    "          } else {\n"
    "            const float vv[2] = {to_f32(sv[at]), to_f32(sv[at + SV])};\n"
    "            fb = split_frag<EXACT>(vv);\n"
    "          }\n"
    "          mma_split<false, EXACT>(o[n], o[n], pf[j], fb);")
SYNC_COPIES = ("      cp_async_commit();\n    }\n",
               "      cp_async_commit();\n      cp_async_wait_all();\n    }\n")
BK32 = ("return dh > 128 ? 32 : 64;", "return 32;")
WARPS4 = ("constexpr int NW = 8;", "constexpr int NW = 4;")
SHORT_FIRST = ("const int qt = gridDim.y - 1 - blockIdx.y;", "const int qt = blockIdx.y;")
NO_WARP_SKIP = ("const bool skip = causal &&", "const bool skip = false &&")
NO_QK = ("for (int kk = 0; kk < KS; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")
NO_PV = ("n < KS; ++n) {\n          const int at = (8 * j + 2 * t) * SV",
         "n < 0; ++n) {\n          const int at = (8 * j + 2 * t) * SV")
# name -> (-D defines, text substitutions, outputs right)
VARIANTS = {
    "kernel": ((), (), True),
    "plain_tf32": ((), (PLAIN_TF32,), False),
    "rna_split": ((), (RNA,), True),
    "smem_split": ((), (BK32, SMEM_BYTES, SMEM_LO, SMEM_SPLIT_TILES, SMEM_K, SMEM_V),
                   True),
    "sync_copies": ((), (SYNC_COPIES,), True),
    "bk32": ((), (BK32,), True),
    "warps4": ((), (WARPS4,), True),
    "short_first": ((), (SHORT_FIRST,), True),
    "no_warp_skip": ((), (NO_WARP_SKIP,), True),
    "no_qk": ((), (NO_QK,), False),
    "no_pv": ((), (NO_PV,), False),
}


def ptxas_f32_128(report: str) -> dict:
    """Registers and spills of the float32 d_head 128 instantiation in an
    ``-Xptxas -v`` report."""
    info, on = {}, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            on = re.search(r"flash_kernelIfLi128E", line) is not None
            continue
        if not on:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            info["spill_store_bytes"], info["spill_load_bytes"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m.group(1))
    return info


def sass_f32_128(lib: Path) -> dict:
    """Instructions of the float32 d_head 128 instantiation by opcode (the
    first word, without modifiers), from ``cuobjdump --dump-sass``: the
    total and the twelve most frequent."""
    import collections
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops, on = collections.Counter(), False
    for line in sass.splitlines():
        if "Function : " in line:
            on = "flash_kernelIfLi128E" in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", line)
        if on and m:
            ops[m.group(1)] += 1
    return {"total": sum(ops.values()), **dict(ops.most_common(12))}


def build(variants: dict, baseline: Path | None) -> tuple[dict, dict]:
    """Compile every variant at once, with the library's flags; returns
    name -> library and name -> ptxas figures."""
    from repro_torch.kernels._build import _SIGNATURES, NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (defines, subs, _) in variants.items():
        text = (baseline if name == "baseline" else SRC).read_text()
        if name != "baseline":
            text = text.replace('#include "tf32_mma.cuh"', HEADER.read_text())
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old!r} is not once in {SRC.name}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(SRC.parent), "-Xptxas", "-v",
             *(f"-D{d}" for d in defines), "-shared", str(cu),
             "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        ptxas[name] = {**ptxas_f32_128(out + err),
                       "sass": sass_f32_128(OUT / f"{name}.so")}
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = lib.flash_attention_launch
        fn.argtypes, fn.restype = _SIGNATURES["flash_attention_launch"]
        libs[name] = lib
    return libs, ptxas


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another flash_attention.cu to time beside this one")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import flash_attention as fl

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    variants = dict(VARIANTS)
    if args.baseline is not None:
        variants["baseline"] = ((), (), True)
    libs, ptxas = build(variants, args.baseline)
    B, T, S, H, KV, dh = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, T, H, dh), generator=g, device="cuda")
    k, v = (torch.randn((B, S, KV, dh), generator=g, device="cuda")
            for _ in range(2))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    runs = [(name, w) for name in variants for w in WINDOWS]

    def call(name, window):
        err = libs[name].flash_attention_launch(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
            S, H, KV, dh, 1, window, stream)
        if err:
            raise RuntimeError(f"{name} window {window}: cudaError_t {err}")

    rows = {name: {"defines": list(d), "outputs_right": right, **ptxas[name]}
            for name, (d, _, right) in variants.items()}
    for window in WINDOWS:
        want = fl.flash_attention_plain(q, k, v, True, window)
        for name in variants:
            call(name, window)
            torch.cuda.synchronize()
            d = (out - want).abs()
            rows[name][f"max_abs_err_w{window}"] = float(d.max())
            rows[name][f"within_tol_w{window}"] = bool(
                (d <= TOL + TOL * want.abs()).all())
            rows[name][f"ms_w{window}"] = []
    for order in (runs, runs[::-1]):
        for name, window in order:
            call(name, window)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                call(name, window)
            end.record()
            torch.cuda.synchronize()
            rows[name][f"ms_w{window}"].append(start.elapsed_time(end) / 20)
    for name, row in rows.items():
        print(f"{name}: " + json.dumps(row), flush=True)
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_f32_ablation.json").write_text(json.dumps(
        {"card": card, "shape": list(SHAPE), "rows": rows}, indent=1))
    kern = rows["kernel"]
    if not all(kern[f"within_tol_w{w}"] for w in WINDOWS):
        raise AssertionError(f"the kernel parts from the plain version: {kern}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
