"""Decode throughput of the serving engine, for one or more checkouts, on the card.

    python3 tools/serve_timing.py [--tree DIR ...] [--reps 3]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Each ``--tree`` is the root of a checkout of the port (the
default is this one; an earlier commit is unpacked with ``git archive``
into the ignored ``build/``).  The trees run in the order given and then
in the reverse order, each run in a process of its own that imports only
that tree's ``src/`` and ``chip_smoke.py`` and builds its kernels there.

A run is ``chip_smoke.py``'s bf16 serve path, timed more closely:
full-width internlm2-1.8b with random weights from seed 0, the ``Engine``
with ``chip_smoke.SERVE`` on ``launch/serve.py``'s stream
(``chip_smoke.SERVE_STREAM``), one untimed run, then ``reps`` runs of a
fresh engine, each timed by the host's clock between two
synchronisations.  Prints one JSON line per run (decode tokens per
second of each rep, and their median) and writes them, with the card's
name and power limit, to ``chiprun_out/serve_timing.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: Path, reps: int) -> dict:
    """The timings of ``tree``, whose ``src/`` and root lead ``sys.path``."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer

    cfg = get_config(cs.ARCH)
    params = transformer.init_params(cfg)
    cs.run_engine(cfg, params)
    tok_s, walls = [], []
    for _ in range(reps):
        eng, _, wall = cs.run_engine(cfg, params)
        tokens = eng.metrics.snapshot()["counters"]["decode_tokens_count"]
        tok_s.append(tokens / wall)
        walls.append(wall)
        del eng
        torch.cuda.empty_cache()
    return {"decode_tokens_per_s": tok_s, "wall_s": walls,
            "median_decode_tokens_per_s": statistics.median(tok_s)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, action="append", default=None,
                    help="root of a checkout to time (repeatable)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        tree = args.child.resolve()
        sys.path[:0] = [str(tree / "src"), str(tree)]
        print("RESULT " + json.dumps(run_tree(tree, args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    rows = []
    for tree in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(tree), "--reps",
             str(args.reps)], capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        result = next(json.loads(line[len("RESULT "):])
                      for line in proc.stdout.splitlines()
                      if line.startswith("RESULT "))
        rows.append({"tree": str(tree), **result})
        print(json.dumps(rows[-1]), flush=True)
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "serve_timing.json").write_text(json.dumps(
        {"card": card, "runs": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
