"""Provenance stamping and lineage checks for benchmark JSON payloads.

The port's copy of ``repro.obs.provenance`` (``src/repro/obs/provenance.py``):
the same schema version, keys, config hash, payload validation, series
lineage diff and CLI.  What a stamp records is the port's: the git sha
(+dirty flag), the python, numpy, torch and CUDA versions, the backend
(``"cuda"`` or ``"cpu"``), on a CUDA device the card's name and power
limit (``nvidia-smi``), the seeds in play, the caller's timings, and a
content hash of the producing config, so payloads from different PRs form
a comparable lineage.

The module doubles as a CLI::

    python -m repro_torch.obs.provenance check BENCH.json --expect expected_series.json
    python -m repro_torch.obs.provenance diff OLD.json NEW.json

``check`` validates the payload schema (provenance present and
well-formed, failures mapped to tracebacks) and fails loudly if any
series named in the guard list is missing; ``diff`` prints the
added/removed series between two payloads and exits non-zero on a loss.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import subprocess
import sys

SCHEMA_VERSION = "repro.obs.provenance/v1"

#: Payload keys that are bookkeeping, not result series.
META_KEYS = {"bench_seconds", "bench_timings", "failures", "provenance"}

REQUIRED_PROVENANCE_KEYS = (
    "schema",
    "git_sha",
    "git_dirty",
    "versions",
    "backend",
    "seeds",
    "config_sha256",
)


def _repo_root() -> str:
    d = os.path.dirname(os.path.abspath(__file__))
    while d != os.path.dirname(d):
        if os.path.isdir(os.path.join(d, ".git")):
            return d
        d = os.path.dirname(d)
    return os.getcwd()


def _run(cmd: list[str], cwd: str | None = None) -> str | None:
    try:
        out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip()


def _git(*args: str) -> str | None:
    return _run(["git", *args], cwd=_repo_root())


def card() -> dict:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    ("unknown" where it prints nothing)."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    line = out.splitlines()[0] if out else ""
    name, _, limit = line.rpartition(", ")
    return {"name": name or "unknown", "power_limit": limit or "unknown"}


def config_hash(config) -> str:
    """sha256 of the canonical-JSON form of the producing config."""
    blob = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def collect(config=None, seeds=None, timings=None,
            device: str = "cuda") -> dict:
    """Gather the provenance block (deterministic under a fixed config and
    device).  ``device`` is where the stamped work ran: ``"cuda"`` (it
    raises without a card) or ``"cpu"``; on a CUDA device the block also
    names the card and its power limit."""
    import numpy
    import torch

    from repro_torch import resolve_device

    dev = resolve_device(device)
    versions = {"python": platform.python_version(),
                "numpy": numpy.__version__, "torch": torch.__version__,
                "cuda": torch.version.cuda}
    prov = {
        "schema": SCHEMA_VERSION,
        "git_sha": _git("rev-parse", "HEAD") or "unknown",
        "git_dirty": bool(_git("status", "--porcelain") or ""),
        "versions": versions,
        "backend": dev.type,
        "seeds": list(seeds) if seeds is not None else [],
        "config_sha256": config_hash(config if config is not None else {}),
    }
    if dev.type == "cuda":
        prov["device"] = dict(card(), torch_name=torch.cuda.get_device_name(
            dev), count=torch.cuda.device_count())
    if timings is not None:
        prov["timings"] = dict(timings)
    return prov


def stamp(payload: dict, config=None, seeds=None, timings=None,
          device: str = "cuda") -> dict:
    """Attach a provenance block to a bench payload (in place) and return
    it."""
    payload["provenance"] = collect(config=config, seeds=seeds,
                                    timings=timings, device=device)
    return payload


def series_keys(payload: dict) -> list[str]:
    """Result-series names in a payload (top-level keys minus bookkeeping)."""
    return sorted(k for k in payload if k not in META_KEYS)


def validate_payload(payload: dict) -> list[str]:
    """Schema check for a stamped bench payload; returns problem strings."""
    problems: list[str] = []
    prov = payload.get("provenance")
    if not isinstance(prov, dict):
        problems.append("missing provenance block")
    else:
        for key in REQUIRED_PROVENANCE_KEYS:
            if key not in prov:
                problems.append(f"provenance missing key {key!r}")
        if prov.get("schema") not in (None, SCHEMA_VERSION):
            problems.append(
                f"provenance schema {prov.get('schema')!r} != {SCHEMA_VERSION!r}"
            )
    failures = payload.get("failures")
    if failures is not None and not isinstance(failures, dict):
        problems.append(
            "failures must map bench name -> traceback string "
            f"(got {type(failures).__name__})"
        )
    if isinstance(failures, dict):
        for name, tb in failures.items():
            if not isinstance(tb, str) or not tb:
                problems.append(f"failure {name!r} lacks a traceback")
    if not series_keys(payload) and not failures:
        problems.append("payload has no result series and no failures")
    return problems


def lineage_diff(old: dict, new: dict) -> dict:
    """Series-level diff between two payloads: what appeared / vanished."""
    old_keys = set(series_keys(old))
    new_keys = set(series_keys(new))
    return {
        "added": sorted(new_keys - old_keys),
        "removed": sorted(old_keys - new_keys),
    }


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.obs.provenance")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_check = sub.add_parser("check", help="validate a stamped bench payload")
    p_check.add_argument("payload")
    p_check.add_argument(
        "--expect",
        default=None,
        help="JSON file: {artifact-name: [required series...]} guard list",
    )
    p_diff = sub.add_parser("diff", help="series lineage diff old -> new")
    p_diff.add_argument("old")
    p_diff.add_argument("new")
    args = parser.parse_args(argv)

    if args.cmd == "check":
        payload = _load(args.payload)
        problems = validate_payload(payload)
        if args.expect:
            guard = _load(args.expect)
            name = os.path.basename(args.payload)
            required = guard.get(name, guard.get("*", []))
            present = set(series_keys(payload))
            for series in required:
                if series not in present:
                    problems.append(
                        f"guarded series {series!r} missing from {name}"
                    )
        for p in problems:
            print(f"provenance-check: {args.payload}: {p}", file=sys.stderr)
        if not problems:
            print(
                f"provenance-check: {args.payload}: ok "
                f"({len(series_keys(payload))} series)"
            )
        return 1 if problems else 0

    diff = lineage_diff(_load(args.old), _load(args.new))
    print(json.dumps(diff, indent=2))
    if diff["removed"]:
        print(
            f"lineage-diff: series removed: {diff['removed']}", file=sys.stderr
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
