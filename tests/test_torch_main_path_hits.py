"""The main path's hit counts on the card, held to the JAX reference.

``chip_smoke.py`` holds every sweep of the port's main path (seven
policies at key space 4096, 60 000 requests, sizes ``IMPL_CAPS``) to
``MAIN_PATH_HITS``: the hits over the 45 000 measured requests as the
replay kernel counted them on the card.  Here the reference's own sweep
(``repro.core.harness.sweep_cache_sizes``, window 8 for every policy but
LRU, as the main path runs it) must give exactly those counts, so the
card's numbers are the reference's and not only the kernel's own.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core.harness import sweep_cache_sizes

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("policy", list(chip_smoke.POLICY_PARAMS))
def test_reference_hits_are_the_main_path_hits(policy):
    kw = {} if policy == "lru" else {"miss_latency_requests": 8}
    sweep = sweep_cache_sizes(policy, chip_smoke.IMPL_CAPS, key_space=4096,
                              n_requests=60_000, **kw,
                              **chip_smoke.POLICY_PARAMS[policy])
    hits = chip_smoke.MAIN_PATH_HITS[policy]
    assert list(sweep["p_hit"]) == [h / chip_smoke.MAIN_PATH_MEASURED
                                    for h in hits]
    assert np.array_equal(
        np.round(sweep["p_hit"] * chip_smoke.MAIN_PATH_MEASURED).astype(int),
        hits)
