"""The sketch_trace kernel's wrapper against the reference, at the edges of
its register ladder.

``repro_torch.kernels.sketch.sketch_trace_lanes`` on CPU tensors (the
kernel's plain version) against the reference's jitted scan
``repro.obs.streaming._sketch_trace`` on a 2 000-key Zipf stream made
from a numpy seed: every ``SketchState`` field equal, the scrap rows and
the float32 EWMAs included, at each cap where the kernel's form changes
(1 and 32: one register slot a thread; 33: two; 96: fig_drift A's four;
256, 512: eight and sixteen; 513: the table in device memory), with hits
and without; one stream whose times go back to windows the ring still
holds (the tick's "time went back" branch).  Then the host's choice of
the kernel's form, ``sketch_trace_form`` (the ladder, packed or not from
the stream's length), the forms the wrapper refuses, and the packed
word's widths against ``csrc/sketch.cuh``.  The kernel itself is held
against the plain version on the card by the ``cuda`` cases of
``tests/test_torch_event_sim_cuda.py`` (``SKETCH_TRACE_CASES``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.streaming as J
from repro.core.harness import zipf_trace
from repro_torch.kernels import sketch as ksk
from repro_torch.obs.streaming import SketchState

N_KEYS, KEY_SPACE, THETA, WINDOW_US = 2_000, 512, 0.9, 100.0
LADDER_CAPS = (1, 32, 33, 96, 256, 512, 513)


def _hold(keys, t, hits, cap, window):
    """The port's state (the plain version, CPU tensors) equal to the
    reference's in every field."""
    port = ksk.sketch_trace_lanes(
        torch.from_numpy(keys.astype(np.int32))[None],
        torch.from_numpy(t.astype(np.float32))[None],
        torch.from_numpy(hits.astype(np.int32))[None],
        sketch_cap=cap, window_us=window)
    ref = J._sketch_trace(jnp.asarray(keys, jnp.int32),
                          jnp.asarray(t, jnp.float32),
                          jnp.asarray(hits, jnp.int32), cap, float(window))
    for f in SketchState._fields:
        a, b = getattr(port, f)[0].numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return port


@pytest.mark.parametrize("with_hits", [True, False], ids=["hits", "nohits"])
@pytest.mark.parametrize("cap", LADDER_CAPS)
def test_state_equals_the_reference_at_the_ladder_edges(cap, with_hits):
    keys = zipf_trace(N_KEYS, KEY_SPACE, THETA, seed=cap)
    rng = np.random.default_rng(cap)
    hits = (rng.random(N_KEYS) < 0.6) if with_hits else np.zeros(N_KEYS)
    port = _hold(keys, np.arange(N_KEYS, dtype=np.float32), hits, cap,
                 WINDOW_US)
    assert int(port.key_count[0]) == N_KEYS
    # every slot filled once the stream has more distinct keys than slots
    filled = int((port.ss_key[0, :cap] >= 0).sum())
    assert filled == min(cap, len(np.unique(keys)))


def test_state_equals_the_reference_when_time_goes_back():
    """Times that step back across windows still in the ring (and back
    past the ring's reach): the tick reloads a window's counters from its
    row, or finds the row holding a newer window."""
    rng = np.random.default_rng(5)
    legs = [np.arange(0, 600), np.arange(150, 420), np.arange(380, 900),
            np.arange(10, 60), np.arange(700, 1_000)]
    t = np.concatenate(legs).astype(np.float32) + 0.5
    keys = zipf_trace(len(t), KEY_SPACE, THETA, seed=11)
    hits = rng.random(len(t)) < 0.5
    _hold(keys, t, hits, 96, 50.0)
    _hold(keys, t, hits, 33, 7.0)


@pytest.mark.parametrize("cap,slots", [
    (1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (96, 4), (128, 4), (129, 8),
    (256, 8), (257, 16), (512, 16), (513, 0), (600, 0), (4096, 0)])
def test_form_follows_the_ladder(cap, slots):
    assert ksk.sketch_trace_form(cap, 24_000) == (slots, slots > 0)


@pytest.mark.parametrize("cap", [1, 96, 512])
def test_form_is_packed_while_counts_fit(cap):
    top = ksk.PACK_MAX_KEYS
    slots = ksk.sketch_trace_form(cap, 1)[0]
    assert ksk.sketch_trace_form(cap, 0) == (slots, True)
    assert ksk.sketch_trace_form(cap, top) == (slots, True)
    assert ksk.sketch_trace_form(cap, top + 1) == (slots, False)
    assert top + 1 == 1 << ksk.PACK_COUNT_BITS
    assert ksk.sketch_trace_form(513, 10) == (0, False)


@pytest.mark.parametrize("form,cap,n", [
    ((3, True), 64, 100),  # no such instantiation
    ((2, False), 96, 100),  # 2 slots a thread hold 64, not 96
    ((0, True), 96, 100),  # the device-memory table is unpacked only
    ((4, True), 96, ksk.PACK_MAX_KEYS + 1)])  # counts past the word
def test_wrapper_refuses_forms_it_has_no_instantiation_of(form, cap, n):
    a = torch.zeros((1, n), dtype=torch.int32)
    with pytest.raises(ValueError):
        ksk.sketch_trace_lanes(a, a.float(), a, sketch_cap=cap,
                               window_us=10.0, form=form)


def test_every_form_gives_the_plain_state_on_the_cpu():
    keys = torch.from_numpy(zipf_trace(300, 64, THETA, seed=3)
                            .astype(np.int32))[None]
    t = torch.arange(300, dtype=torch.float32)[None]
    h = (keys % 3 == 0).to(torch.int32)
    want = ksk.sketch_trace_plain(keys, t, h, sketch_cap=40, window_us=20.0)
    for form in (None, (2, True), (2, False), (16, True), (0, False)):
        got = ksk.sketch_trace_lanes(keys, t, h, sketch_cap=40, window_us=20.0,
                                     form=form)
        for f in SketchState._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (form, f)


def test_packed_word_widths_match_the_header():
    """The host's packed-count width is the header's: 31 bits less the
    slot bits, which hold the ladder's largest cap."""
    src = (Path(ksk.__file__).parent / "csrc" / "sketch.cuh").read_text()
    slot_bits = int(re.search(r"PACK_SLOT_BITS = (\d+);", src).group(1))
    assert "PACK_COUNT_BITS = 31 - PACK_SLOT_BITS;" in src
    assert ksk.PACK_COUNT_BITS == 31 - slot_bits
    assert 32 * max(ksk.REG_SLOTS) == 1 << slot_bits
    ladder = re.search(r"the host's ladder: ([\d, ]+)\)", src).group(1)
    assert tuple(int(x) for x in ladder.split(", ")) == ksk.REG_SLOTS
