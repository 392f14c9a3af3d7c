"""Where the tensor-core flash-attention kernel spends its time, on the card.

    python3 tools/flash_sm90_ablation.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Builds ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu``
as it is and three copies with parts of the work cut out (text
substitutions; each copy raises if its anchor is missing), each into its
own library under ``build/flash_sm90_ablation/``:

* ``kernel``: the kernel as it is;
* ``no_qk``: without the Q K^T products (the softmax runs on stale logits);
* ``no_pv``: without the P V products;
* ``loads_only``: without either product and with 2^x replaced by a
  constant: what is left is the copies, the barriers and the loop.

Their outputs are wrong by design; only their times mean anything.  Each
runs at the prefill path's shape of ``chip_smoke.py`` (B 4, H 16, KV 8,
T = S = 2048, d_head 128; causal, causal with a 1024 window, and
bidirectional) and at d_head 64 (B 2, causal), timed with CUDA events over
20 launches after one warm-up.  Beside each time: the bytes the kernel's
copies move from L2 into shared memory (every q tile once, every visited
K/V tile once per item) and that rate.  Prints one JSON line per shape and
writes them, with the card's name and power limit, to
``chiprun_out/flash_sm90_ablation.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention_sm90.cu"
OUT = ROOT / "build" / "flash_sm90_ablation"
BQ = BK = 128  # the kernel's q-tile rows and K/V-tile columns

NO_QK = ("wgmma_ss_n128(s, sw128_desc(", "if (0) wgmma_ss_n128(s, sw128_desc(")
NO_PV = ("wgmma_rs<DH>(o, pa[kk]", "if (0) wgmma_rs<DH>(o, pa[kk]")
NO_EXP = ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));', "y = 0.5f;")
VARIANTS = {"kernel": (), "no_qk": (NO_QK,), "no_pv": (NO_PV,),
            "loads_only": (NO_QK, NO_PV, NO_EXP)}
SHAPES = (  # (B, T, S, H, KV, dh, causal, window)
    (4, 2048, 2048, 16, 8, 128, True, 0),
    (4, 2048, 2048, 16, 8, 128, True, 1024),
    (4, 2048, 2048, 16, 8, 128, False, 0),
    (2, 2048, 2048, 16, 8, 64, True, 0),
)


def build() -> dict:
    """Compile every variant at once, with the library's flags; returns
    name -> launcher."""
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: anchor {old!r} not in {SRC.name}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", str(cu), "-o", str(OUT / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_sm90_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def copied_bytes(B, T, S, H, KV, dh, causal, window) -> int:
    """Bytes the producer copies: each item's q tile and the K and V tiles
    it visits (the kernel's own tile range)."""
    nq, nk = -(-T // BQ), -(-S // BK)
    tiles = 0
    for qt in range(nq):
        lo, hi = 0, nk
        if causal:
            hi = min(nk, (min(qt * BQ + BQ, T) - 1) // BK + 1)
            if window:
                lo = max(0, qt * BQ - window + 1) // BK
        tiles += hi - lo
    return B * H * (nq * BQ * dh * 2 + tiles * 2 * BK * dh * 2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    libs = build()
    rows = []
    for shape in SHAPES:
        B, T, S, H, KV, dh, causal, window = shape
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                   for s in ((B, T, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        nbytes = copied_bytes(*shape)
        row = {"shape": list(shape), "copied_bytes": nbytes}
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         B, T, S, H, KV, dh, int(causal), window, stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            call()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            row[name] = {"ms": ms, "copied_tb_per_s": nbytes / ms / 1e9}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_sm90_ablation.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
