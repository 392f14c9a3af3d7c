"""Architecture registry: --arch <id> -> ModelConfig.

A copy of ``src/repro/configs/registry.py``; the per-architecture modules
beside it copy ``src/repro/configs/*.py``.  Change both together.

All ten assigned architectures (exact dimensions from the assignment table)
plus the paper's own "policy lab" needs no model at all — the cache layer is
model-agnostic.  Sources are cited per file.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "arctic-480b",
    "llama4-scout-17b-a16e",
    "chameleon-34b",
    "qwen3-32b",
    "gemma3-27b",
    "internlm2-1.8b",
    "nemotron-4-15b",
    "rwkv6-7b",
    "zamba2-1.2b",
    "whisper-tiny",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get_config(arch: str, reduced: bool = False, **overrides):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(_MODULES[arch])
    cfg = mod.config()
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
