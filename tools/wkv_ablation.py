"""What each design choice of the chunked WKV6 kernel is worth, on the card.

    python3 tools/wkv_ablation.py [--baseline OLD/linear_scan.cu]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Builds ``src/repro_torch/kernels/csrc/linear_scan.cu`` as
it is and copies with one choice changed, each into its own library under
``build/wkv_ablation/`` (all compiled at once):

* ``kernel``: the library's build; its sequential kernel is timed too;
* ``plain_tf32``: each product in plain TF32, one ``mma`` (never on a
  path: its max error is printed beside its time);
* ``chunk32``: chunks of 32 timesteps in place of 64;
* ``jblocks2`` / ``jblocks4``: two or four blocks per (b, h), each a
  slice of the value columns, each computing the intra matrix A again;
* ``sync_copies``: each chunk's copies waited for as soon as issued, in
  place of overlapping the previous chunk's work;
* ``warps16``: blocks of 16 warps in place of 8 (a text substitution);
* ``baseline``: with ``--baseline``, another source of the same
  interface (an earlier version, unpacked with ``git show
  <commit>:src/repro_torch/kernels/csrc/linear_scan.cu`` into the ignored
  ``build/``), built with its own defaults;
* cut-outs, whose outputs are wrong by design (text substitutions; each
  copy raises unless its anchor occurs once): ``no_diagonal`` (the diagonal
  blocks' quadrants on the CUDA cores), ``no_quadrants`` (their
  lower-left quadrants' products), ``no_offdiagonal`` (the off-diagonal
  blocks' products), ``no_y_products`` (A V and the inter-chunk product),
  ``no_state_products`` (the state update's product).

Every variant runs at the prefill path's shape of ``chip_smoke.py`` (B 2,
T 2048, 64 heads of 64; bf16 r/k/v, float32 w and y; the model's decays
exp(-exp(x)), x uniform in [-8, 4]; a zero state updated in place), timed
by CUDA events over 20 launches after one warm-up, in two rounds, the
second in the reverse order.  Each variant's y and final state are held
against the plain version: the max |d| and the scale are printed (the
library's kernel must be within 1e-4 of the scale).  Prints one JSON line
per variant and writes them, with the card's name and power limit, to
``chiprun_out/wkv_ablation.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "linear_scan.cu"
OUT = ROOT / "build" / "wkv_ablation"
SHAPE = (2, 2048, 64, 64)  # B, T, H, dh: chip_smoke.WKV_FULL

NO_DIAGONAL = ("for (int q = tid; q < NSUB * SUB * NI; q += NTHREADS) {",
               "for (int q = tid; q < 0; q += NTHREADS) {")
WARPS16 = ("constexpr int NW = 8;", "constexpr int NW = 16;")
NO_QUADRANTS = ("for (int a = (warp + NW - NPAIR * (2 / NH) % NW) % NW; a < NSUB; a += NW) {",
                "for (int a = (warp + NW - NPAIR * (2 / NH) % NW) % NW; a < 0; a += NW) {")
NO_OFFDIAGONAL = ("for (int q = warp; q < NPAIR * (2 / NH); q += NW) {",
                  "for (int q = warp; q < 0; q += NW) {")
NO_Y_PRODUCTS = ("for (int q = warp; q < NSUB * NG; q += NW) {",
                 "for (int q = warp; q < 0; q += NW) {")
NO_STATE_PRODUCTS = ("for (int k0 = 0; k0 < C; k0 += 8) {",
                     "for (int k0 = 0; k0 < 0; k0 += 8) {")
# name -> (-D defines, text substitutions, outputs right)
VARIANTS = {
    "kernel": ((), (), True),
    "plain_tf32": (("WKV_SPLIT_TF32=0",), (), True),
    "chunk32": (("WKV_CHUNK=32",), (), True),
    "jblocks2": (("WKV_JBLOCKS=2",), (), True),
    "jblocks4": (("WKV_JBLOCKS=4",), (), True),
    "sync_copies": (("WKV_ASYNC_COPY=0",), (), True),
    "warps16": ((), (WARPS16,), True),
    "no_diagonal": ((), (NO_DIAGONAL,), False),
    "no_quadrants": ((), (NO_QUADRANTS,), False),
    "no_offdiagonal": ((), (NO_OFFDIAGONAL,), False),
    "no_y_products": ((), (NO_Y_PRODUCTS,), False),
    "no_state_products": ((), (NO_STATE_PRODUCTS,), False),
}


def build(variants: dict, baseline: Path | None) -> dict:
    """Compile every variant at once, with the library's flags; returns
    name -> library."""
    from repro_torch.kernels._build import _SIGNATURES, NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for name, (defines, subs, _) in variants.items():
        text = baseline.read_text() if name == "baseline" else src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old!r} is not once in {SRC.name}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(SRC.parent),
             *(f"-D{d}" for d in defines), "-shared",
             str(cu), "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ("wkv6_launch", "wkv6_chunked_launch"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = _SIGNATURES[fn]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another linear_scan.cu to time beside this one")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import linear_scan as ls

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
    libs = build(variants, args.baseline)
    B, T, H, dh = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    r, k, v = (torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(SHAPE, generator=g, device="cuda") * 12 - 8))
    u = torch.randn((H, dh), generator=g, device="cuda")
    want_s, want_y = ls.wkv6_scan_plain(r, k, v, w, u)
    y = torch.empty(SHAPE, device="cuda")
    state = torch.zeros((B, H, dh, dh), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    runs = [(name, "chunked") for name in variants] + [("kernel", "sequential")]

    def call(name, route):
        fn = getattr(libs[name], "wkv6_chunked_launch" if route == "chunked"
                     else "wkv6_launch")
        err = fn(1, 0, 0, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), state.data_ptr(), y.data_ptr(),
                 B, T, H, dh, stream)
        if err:
            raise RuntimeError(f"{name} {route}: cudaError_t {err}")

    rows = {}
    for name, route in runs:  # outputs from a zero state
        state.zero_()
        call(name, route)
        torch.cuda.synchronize()
        key = name if route == "chunked" else "sequential"
        rows[key] = {
            "defines": list(variants[name][0]), "route": route,
            "outputs_right": variants[name][2],
            "y_max_abs_err": float((y - want_y).abs().max()),
            "y_scale": float(want_y.abs().max()),
            "state_max_abs_err": float((state - want_s).abs().max()),
            "state_scale": float(want_s.abs().max()), "ms": []}
    for order in (runs, runs[::-1]):
        for name, route in order:
            call(name, route)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                call(name, route)
            end.record()
            torch.cuda.synchronize()
            rows[name if route == "chunked" else "sequential"]["ms"].append(
                start.elapsed_time(end) / 20)
    kern = rows["kernel"]
    if kern["y_max_abs_err"] > 1e-4 * kern["y_scale"] or \
            kern["state_max_abs_err"] > 1e-4 * kern["state_scale"]:
        raise AssertionError(f"the chunked kernel parts from the plain version: {kern}")
    for name, row in rows.items():
        print(f"{name}: " + json.dumps(row), flush=True)
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv_ablation.json").write_text(json.dumps(
        {"card": card, "shape": list(SHAPE), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
