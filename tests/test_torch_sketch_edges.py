"""The sketched event sim's edge cases, on the CPU.

The sketched coalescing, open-loop and tiered instantiations of the
event-sim kernel log each event and replay every 32 of them, with the
window's per-branch completions in registers and each block of 32 keys'
count-min adds made at once (``csrc/sketch.cuh`` ``SimLane``).
``tests/test_torch_event_sim_cuda.py``'s ``SKETCH_CASES`` hold them to the
plain version on the card at the edges where that design could go wrong:
more SpaceSaving slots than the warp has threads, windows that wrap the
ring, a partial count-min block at the end, 32 branches and past it.
Here, on the CPU: each of those cases reaches its edge in the plain
version, with every simulation output the unsketched plain version's (so
the card's check covers the edge); the heapq oracle's sketch at the same
edges is the reference's; and the launch struct is the kernel's.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import build as jbuild
from repro.core.py_sim import simulate_py as jsimulate_py
from repro_torch.core.py_sim import simulate_py
from repro_torch.kernels import sketch as ksk
from repro_torch.obs import streaming as tst
from test_torch_event_sim_cuda import SKETCH_CASES, hold_sketch_case, sketch_lanes
from test_torch_streaming import _port_network, _same_estimates

# the SKETCH_CASES cases at an edge of the logged design
EDGE_CASES = [c for c in SKETCH_CASES
              if c[2]["cap"] > 32 or {"wraps", "partial", "branches"} & set(c[2])]


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_sketch_case_reaches_its_edge(case):
    """The plain version on the case: its own property (the branches, the
    ring's wrap or the partial block), more SpaceSaving slots filled than
    32 where the cap passes 32, and every simulation output the unsketched
    run's."""
    _, plain_fn, spec, seeds, kw = sketch_lanes(case, torch.device("cpu"))
    on = plain_fn(spec, seeds, **dict(kw, sketch_cap=case[2]["cap"],
                                      window_us=case[2]["window"]))
    off = plain_fn(spec, seeds, **kw)
    hold_sketch_case(case, on)
    cap = case[2]["cap"]
    if cap > 32:
        filled = (on.sketch.ss_count[:, :cap] > 0).sum(dim=1)
        assert int(filled.max()) > 32
    for f, a in off._asdict().items():
        b = getattr(on, f)
        if f == "sketch" or (a is None and b is None):
            continue
        assert torch.equal(a, b), f
    assert int(on.sketch.win_done_count.sum()) > 0


@pytest.mark.parametrize("kw, cap, window_us", [
    (dict(coalesce_flows=64, coalesce_theta=0.99), 32, 500.0),
    (dict(coalesce_flows=64, coalesce_theta=0.99), 33, 500.0),
    (dict(coalesce_flows=64, coalesce_theta=0.99), 48, 500.0),
    (dict(coalesce_flows=8), 8, 10.0),
    (dict(arrival_rate=0.03, max_in_system=128, coalesce_flows=64), 32,
     500.0),
    (dict(arrival_rate=0.03, max_in_system=128, coalesce_flows=64), 40,
     500.0),
    (dict(arrival_rate=0.03, max_in_system=128, coalesce_flows=8), 8, 10.0),
], ids=["coalescing-cap32", "coalescing-cap33", "coalescing-cap48",
        "coalescing-wraps", "open-cap32", "open-cap40", "open-wraps"])
def test_oracle_sketch_at_the_edges_equals_the_reference(kw, cap, window_us):
    """The heapq oracle with the sketch at the kernel cases' edges: caps
    about 32, and windows short enough that the ring wraps."""
    net = jbuild("lru", disk_us=100.0)
    args = dict(n_requests=1_500, seed=5, full=True, sketch_cap=cap,
                window_us=window_us, **kw)
    port = simulate_py(_port_network(net), 0.6, **args)["sketch"]
    ref = jsimulate_py(net, 0.6, **args)["sketch"]
    _same_estimates(port, ref)
    assert port.key_count > cap
    if window_us < 100.0:
        assert port.window_id.max() >= tst.N_WINDOWS


@pytest.mark.parametrize("cap", [32, 33])
def test_tiered_oracle_sketch_at_cap_32_equals_the_reference(cap):
    import repro.hierarchy as JH
    import repro_torch.hierarchy as TH

    args = dict(n_requests=1_500, seed=4, coalesce_flows=4, sketch_cap=cap,
                window_us=500.0)
    kw = dict(n_clients=2, n_shards=2, mpl=16, disk_us=50.0)
    port = TH.simulate_hierarchy_py(TH.hierarchy_network("lru", "lru", **kw),
                                    0.5, **args)
    ref = JH.simulate_hierarchy_py(JH.hierarchy_network("lru", "lru", **kw),
                                   0.5, **args)
    _same_estimates(port.sketches, ref.sketches)
    assert port.sketches.key_count > 0


def test_sketch_args_are_the_kernel_struct():
    """``_SketchArgs``' fields are ``SketchArgs``' of ``csrc/sketch.cuh``,
    in order: pointers, then ``window_us``, then the ints."""
    src = (Path(ksk.__file__).parent / "csrc" / "sketch.cuh").read_text()
    body = re.search(r"struct SketchArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    want = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        kind, names = re.match(r"((?:const )?\w+\*?)\s+(.*)", decl).groups()
        for n in names.split(","):
            want.append((n.strip(), "p" if kind.endswith("*") else kind))
    got = [(n, {"c_void_p": "p", "c_float": "float", "c_int": "int"}[
        t.__name__]) for n, t in ksk._SketchArgs._fields_]
    assert got == want
