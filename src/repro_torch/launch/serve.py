"""Serving driver: run the continuous-batching engine on a Zipf request
stream under any of the Table-1 eviction policies, then report both the
measured controller statistics and the paper-model throughput prediction.
Port of ``repro.launch.serve``, with ``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --policy lru --requests 32 --device cuda
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.harness import (PAPER_SERVICES, ServiceTimes,
                                      empirical_network)
from repro_torch.models import transformer
from repro_torch.serving import Engine, ServeConfig
from repro_torch.training.data import zipf_request_stream


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="internlm2-1.8b")
    ap.add_argument("--policy", default="lru")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prefixes", type=int, default=4)
    ap.add_argument("--prefix-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--bypass", type=float, default=0.0)
    ap.add_argument("--mpl", type=int, default=72)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    if cfg.encdec:
        raise SystemExit("enc-dec archs are served via examples/; see DESIGN.md")
    params = transformer.init_params(cfg, seed=0, device=device)
    eng = Engine(cfg, params, ServeConfig(
        max_seqs=4, max_seq_len=256, page_size=8, n_pages=128,
        prefix_capacity=64, policy=args.policy, max_new_tokens=args.max_new,
        bypass_fraction=args.bypass,
    ), device=device)
    reqs = zipf_request_stream(args.requests, args.prefixes, args.prefix_len,
                               cfg.vocab, seed=0, new_tokens=6)
    for _, toks in reqs:
        eng.submit(toks)
    stats = eng.run()
    print("engine stats:", stats)

    # paper-model throughput prediction from the measured controller profile
    s = eng.prefix.stats
    n = s.chunk_hits + s.chunk_misses
    hits = np.zeros(n, dtype=bool)
    hits[: s.chunk_hits] = True
    hit_ops, miss_ops = eng.prefix.mean_ops_per_chunk()
    ops = np.where(hits[:, None], np.round(hit_ops), np.round(miss_ops)).astype(int)
    meas = empirical_network(args.policy, hits, ops,
                             service=PAPER_SERVICES.get(args.policy, ServiceTimes()),
                             mpl=args.mpl, warmup_frac=0.0)
    print(f"chunk hit ratio: {meas.hit_ratio:.3f}")
    print(f"controller throughput bound (Thm 7.1): "
          f"{meas.throughput_bound():.3f} Mreq/s at MPL={args.mpl}")
    return stats


if __name__ == "__main__":
    main()
