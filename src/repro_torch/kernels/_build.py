"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into one shared library with a
plain C interface.  The build happens at first use, into
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that hashes the sources and flags, so a
stale library is never loaded.  A failed build raises with nvcc's stderr;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

# Dynamic shared memory one block may use on sm_90 (227 KB).
MAX_SHARED_BYTES = 232_448

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points: (argtypes, restype).  Every launcher returns cudaError_t.
_SIGNATURES = {
    "replay_launch": ([_I, _I] + [_P] * 10 + [_LL] + [_I] * 4 + [_P], _I),
    "replay_bytes": ([_I, _LL, _LL, _I, _I], _LL),
    "event_sim_slots": ([_I], _I),
    "event_sim_ext_launch": ([_P] * 3, _I),
    "event_sim_ext_shared_bytes": ([_P, _I], _I),
    "sketch_trace_launch": ([_P] * 4 + [_I] * 4 + [_P], _I),
    "lru_update_launch": ([_P] * 5 + [_I] * 3 + [_P], _I),
    "lru_update_blocks": ([_I], _I),
    "flash_attention_launch": ([_I] + [_P] * 4 + [_I] * 8 + [_P], _I),
    "flash_attention_sm90_launch": ([_P] * 4 + [_I] * 8 + [_P], _I),
    "paged_attention_launch": ([_I] + [_P] * 6 + [_I] * 6 + [_P], _I),
    "paged_attention_shared_bytes": ([_I] * 4, _I),
    "wkv6_launch": ([_I] * 3 + [_P] * 8 + [_I] * 4 + [_P], _I),
    "wkv6_chunked_launch": ([_I] * 3 + [_P] * 8 + [_I] * 4 + [_P], _I),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")
    return nvcc


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with stderr if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def build_library() -> Path:
    """Compile and link every ``csrc/*.cu``; returns the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources, objs)])
        part = Path(tmp) / lib.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(part)]])
        os.replace(part, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source set) and load the kernel library."""
    dll = ctypes.CDLL(str(build_library()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return dll


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
