"""The port's serving stack against ``repro.serving``, on the same inputs.

``chunk_hashes`` and the prefix-cache controller (all seven policies) are
pure host code and must equal the reference's exactly.  The port's
``Engine`` on reduced internlm2, with the reference's weights converted,
must serve the same tokens and end with the same ``stats()`` as the JAX
``Engine`` on the same request stream (both in float32).
``forecast_network`` — one pod, and a hash-routed cluster of pods
(``n_shards > 1``) — must be the reference's network, and
``forecast_slo`` its SLO forecast.  With the admission-stream sketch
(``ServeConfig.sketch_cap``) the telemetry's streaming summary, the
observed profile and the forecast it feeds equal the reference's.  Modes
not ported yet raise, naming their ROADMAP item.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import transformer as jt
from repro.models.layers import param_values
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.kv_pages import PageAllocator as JPageAllocator
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro.serving.prefix_cache import chunk_hashes as jchunk_hashes
from repro.training.data import zipf_request_stream as jzipf_request_stream
from repro_torch.configs.registry import get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.models import transformer as tt
from repro_torch.serving import Engine, PageAllocator, PrefixCache, ServeConfig
from repro_torch.serving import kv_pages
from repro_torch.serving.prefix_cache import chunk_hashes
from repro_torch.training.data import zipf_request_stream

POLICIES = ["lru", "fifo", "prob_lru", "clock", "slru", "s3fifo", "sieve"]


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("internlm2-1.8b", reduced=True)
    cfg = get_config("internlm2-1.8b", reduced=True)
    jp = param_values(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                       cfg, device="cpu")
    return jcfg, cfg, jp, tp


def test_request_stream_is_the_reference_stream():
    a = zipf_request_stream(12, 4, 16, 256, seed=3, new_tokens=5)
    b = jzipf_request_stream(12, 4, 16, 256, seed=3, new_tokens=5)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("page_size", [1, 4, 8])
def test_chunk_hashes_equal_the_reference(page_size):
    rng = np.random.default_rng(page_size)
    for n in (0, 3, 8, 33):
        toks = rng.integers(0, 92544, n)
        assert chunk_hashes(toks, page_size) == jchunk_hashes(toks, page_size)
    assert chunk_hashes([1, 2, 3, 4], 4)[0] == chunk_hashes([1, 2, 3, 4, 9], 4)[0]


def _drive(cache_cls, alloc_cls, policy, reqs, page_size, capacity, n_pages):
    """A model-free run of the controller over a request stream: lookup,
    then insert every full chunk past the hit prefix (the engine's order).
    Returns the trace of (hit pages, inserted pages, free pages) and the
    cache."""
    rng = np.random.default_rng(0)
    cache = cache_cls(alloc_cls(n_pages), capacity, policy=policy)
    trace = []
    for _, toks in reqs:
        hashes = chunk_hashes(toks, page_size)
        pages, n_hit = cache.lookup(hashes)
        inserted = [cache.insert(h, rng.random()) for h in hashes[n_hit:]]
        trace.append((pages, inserted, cache.allocator.n_free))
    return trace, cache


@pytest.mark.parametrize("policy", POLICIES)
def test_prefix_cache_equals_the_reference(policy):
    reqs = zipf_request_stream(60, 12, 24, 500, seed=4, new_tokens=6)
    got, tc = _drive(PrefixCache, PageAllocator, policy, reqs, 8, 20, 24)
    want, jc = _drive(JPrefixCache, JPageAllocator, policy, reqs, 8, 20, 24)
    assert got == want
    ts, js = tc.stats, jc.stats
    for f in ("lookups", "chunk_hits", "chunk_misses", "inserts", "evictions",
              "bypassed"):
        assert getattr(ts, f) == getattr(js, f), f
    np.testing.assert_array_equal(ts.ops, js.ops)
    assert ts.evictions > 0, "the stream must evict"
    assert tc.pages == jc.pages
    for a, b in zip(tc.mean_ops_per_chunk(), jc.mean_ops_per_chunk()):
        np.testing.assert_array_equal(a, b)


def _serve_both(models, reqs, **kw):
    jcfg, cfg, jp, tp = models
    serve = dict(max_seqs=3, max_seq_len=128, page_size=8, n_pages=64,
                 prefix_capacity=32, policy="lru", max_new_tokens=5)
    serve.update(kw)
    jeng = JEngine(jcfg, jp, JServeConfig(**serve))
    teng = Engine(cfg, tp, ServeConfig(**serve), device="cpu")
    jrs = [jeng.submit(t) for _, t in reqs]
    trs = [teng.submit(t) for _, t in reqs]
    jeng.run()
    teng.run()
    return jeng, teng, jrs, trs


@pytest.mark.parametrize("policy,kw", [
    ("lru", {}),
    ("s3fifo", dict(n_pages=16, prefix_capacity=4)),  # evicting
])
def test_engine_serves_the_reference_tokens(models, policy, kw):
    reqs = zipf_request_stream(8, n_prefixes=3, prefix_len=16,
                               vocab=models[1].vocab, seed=1, new_tokens=5)
    jeng, teng, jrs, trs = _serve_both(models, reqs, policy=policy, **kw)
    assert [r.out for r in trs] == [r.out for r in jrs]
    assert [(r.prefill_tokens_computed, r.prefill_tokens_skipped)
            for r in trs] == [(r.prefill_tokens_computed,
                               r.prefill_tokens_skipped) for r in jrs]
    assert teng.stats() == jeng.stats()
    assert teng.ticks == jeng.ticks
    assert teng.stats()["chunk_hit_ratio"] > 0
    assert teng.stats()["evictions"] > 0 or policy == "lru"
    tel = teng.telemetry()
    assert tel["stats"] == teng.stats()
    assert (tel["metrics"]["counters"]
            == jeng.telemetry()["metrics"]["counters"])


def test_outputs_identical_with_and_without_prefix_cache(models):
    _, cfg, _, tp = models
    reqs = zipf_request_stream(8, n_prefixes=3, prefix_len=16,
                               vocab=cfg.vocab, seed=1, new_tokens=5)
    outs = []
    for bypass in (0.0, 1.0):
        eng = Engine(cfg, tp, ServeConfig(
            max_seqs=3, max_seq_len=128, page_size=8, n_pages=64,
            prefix_capacity=32, policy="sieve", bypass_fraction=bypass,
            max_new_tokens=5), device="cpu")
        rs = [eng.submit(t) for _, t in reqs]
        eng.run()
        outs.append([r.out for r in rs])
        if not bypass:
            assert eng.prefix.stats.chunk_hits > 0
    assert outs[0] == outs[1]


def test_full_hit_reprefills_the_last_token(models):
    _, cfg, _, tp = models
    prompt = np.arange(24) % cfg.vocab
    eng = Engine(cfg, tp, ServeConfig(max_seqs=2, max_seq_len=128, page_size=8,
                                      n_pages=32, prefix_capacity=16,
                                      max_new_tokens=4), device="cpu")
    r1 = eng.submit(prompt)
    eng.run()
    r2 = eng.submit(prompt)
    eng.run()
    assert (r1.prefill_tokens_skipped, r2.prefill_tokens_skipped) == (0, 24)
    assert r2.prefill_tokens_computed == 1
    assert r2.out == r1.out


def test_no_page_leaks(models):
    _, cfg, _, tp = models
    reqs = zipf_request_stream(12, n_prefixes=6, prefix_len=16,
                               vocab=cfg.vocab, seed=2, new_tokens=4)
    eng = Engine(cfg, tp, ServeConfig(max_seqs=3, max_seq_len=128, page_size=8,
                                      n_pages=16, prefix_capacity=4,
                                      max_new_tokens=4), device="cpu")
    for _, t in reqs:
        eng.submit(t)
    eng.run()
    assert eng.prefix.stats.evictions > 0
    assert eng.allocator.n_free + len(eng.prefix.pages) == eng.serve.n_pages


def test_pool_pages_hold_the_prefix_kv(models):
    """The pages of a resident prefix hold the K/V a fresh prefill of that
    prefix computes, and paged attention over them equals dense attention
    over ``gather_pages`` of the same pages (the plain version, on CPU)."""
    _, cfg, _, tp = models
    prompt = (np.arange(21) * 7) % cfg.vocab
    eng = Engine(cfg, tp, ServeConfig(max_seqs=2, max_seq_len=64, page_size=8,
                                      n_pages=16, prefix_capacity=8,
                                      max_new_tokens=2), device="cpu")
    eng.submit(prompt)
    eng.run()
    pages = [eng.prefix.pages[h] for h in chunk_hashes(prompt, 8)]
    cache = tt.init_cache(cfg, 1, 64, device="cpu")
    tt.forward(tp, prompt[None, :16], cfg, caches=cache, cache_len=[0],
               device="cpu")
    pk, pv = eng.layer_pools()[0]
    got = pk[torch.tensor(pages)].reshape(16, *pk.shape[2:])
    np.testing.assert_allclose(got.numpy(), cache[0][0].k[0, 0, :16].numpy(),
                               rtol=1e-6, atol=1e-6)
    dense = tt.init_cache(cfg, 1, 64, device="cpu")
    kv_pages.gather_pages(dense[0][0].k[0:1], eng.pool[0][0].k[0:1], 0, pages)
    kv_pages.gather_pages(dense[0][0].v[0:1], eng.pool[0][0].v[0:1], 0, pages)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, cfg.n_heads, cfg.d_head),
                                             dtype=np.float32))
    bt = torch.tensor([pages], dtype=torch.int32)
    sl = torch.tensor([13], dtype=torch.int32)
    before = tpaged.paged_attention.launches
    out = tpaged.paged_attention(q, pk, pv, bt, sl)
    assert tpaged.paged_attention.launches == before
    k, v = dense[0][0].k[0, :, :13], dense[0][0].v[0, :, :13]
    g = cfg.n_heads // cfg.n_kv_heads
    logits = torch.einsum("bhd,bshd->bhs", q, k.repeat_interleave(g, 2)) \
        * cfg.d_head**-0.5
    want = torch.einsum("bhs,bshd->bhd", logits.softmax(-1),
                        v.repeat_interleave(g, 2))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _net_summary(net, grid=(0.0, 0.3, 0.7, 0.95), pstar_grid=2001):
    return {
        "name": net.name, "mpl": net.mpl,
        "stations": [(s.name, s.kind, s.servers, s.dist, s.bound,
                      [s.mean_service(p) for p in grid])
                     for s in net.stations],
        "branches": [(b.name, b.visits, [b.probability(p) for p in grid])
                     for b in net.branches],
        "upper": net.throughput_upper(np.asarray(grid)).tolist(),
        "p_star": net.p_star(grid=pstar_grid),
    }


@pytest.mark.parametrize("kw", [
    dict(),
    dict(coalesce_flows=8),
    dict(replicas=8, cores=16, batched_update=True),
    dict(n_shards=4),
    dict(n_shards=4, coalesce_flows=8, cores=16),
])
def test_forecast_network_equals_the_reference(models, kw):
    reqs = zipf_request_stream(10, n_prefixes=4, prefix_len=16,
                               vocab=models[1].vocab, seed=4, new_tokens=4)
    jeng, teng, _, _ = _serve_both(models, reqs, max_seqs=2,
                                   max_new_tokens=4, disk_servers=4)
    want = jeng.forecast_network(step_us=6000.0, prefill_us=40.0, **kw)
    got = teng.forecast_network(step_us=6000.0, prefill_us=40.0, **kw)
    got.validate()
    a, b = _net_summary(got), _net_summary(want)
    assert a.pop("p_star") == pytest.approx(b.pop("p_star"), abs=1e-12)
    np.testing.assert_allclose(a.pop("upper"), b.pop("upper"), rtol=1e-12)
    assert a == b


@pytest.mark.parametrize("kw", [
    dict(),
    dict(coalesce_flows=8, percentile=0.9),
])
def test_forecast_slo_equals_the_reference(models, kw):
    """The SLO forecast over the measured controller network: every field
    of the port's LatencyForecast equals the reference's to rtol 1e-12."""
    reqs = zipf_request_stream(10, n_prefixes=4, prefix_len=16,
                               vocab=models[1].vocab, seed=4, new_tokens=4)
    jeng, teng, _, _ = _serve_both(models, reqs, max_seqs=2,
                                   max_new_tokens=4, disk_servers=4)
    grid = np.linspace(0.0, 1.0, 41)
    args = dict(step_us=6000.0, prefill_us=40.0, arrival_rate=0.002,
                slo_us=5e4, p_grid=grid, **kw)
    want = jeng.forecast_slo(**args)
    got = teng.forecast_slo(**args)
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None or isinstance(b, str):
            assert a == b, f.name
        else:
            np.testing.assert_allclose(np.asarray(a, float),
                                       np.asarray(b, float), rtol=1e-12,
                                       err_msg=f.name)


def test_forecast_slo_takes_the_reference_parameters():
    ref = inspect.signature(JEngine.forecast_slo).parameters
    port = inspect.signature(Engine.forecast_slo).parameters
    assert [(p.name, p.kind, p.default) for p in port.values()] == \
        [(p.name, p.kind, p.default) for p in ref.values()]


def test_unported_modes_raise(models):
    _, cfg, _, tp = models
    # the admission sketch is ported: an engine takes it, and without it
    # observed_profile refuses, as the reference's
    assert Engine(cfg, tp, ServeConfig(sketch_cap=64), device="cpu"
                  ).telemetry()["streaming"]["key_count"] == 0
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        Engine(get_config("zamba2-1.2b", reduced=True), tp, ServeConfig(),
               device="cpu")
    with pytest.raises(ValueError, match="enc-dec"):
        Engine(get_config("whisper-tiny", reduced=True), tp, ServeConfig(),
               device="cpu")
    eng = Engine(cfg, tp, ServeConfig(max_new_tokens=2), device="cpu")
    # the hierarchy forecast is ported: with no measured fill ops the miss
    # route ends at the origin, which compose_tiers refuses, as the
    # reference does (test_hierarchy_forecast_equals_the_reference)
    with pytest.raises(ValueError, match="post-disk fill station"):
        eng.forecast_network(6000.0, 40.0, tiers=2)
    # observed_profile is ported; without the sketch it refuses, as the
    # reference's does
    with pytest.raises(ValueError, match="sketch_cap"):
        eng.observed_profile()


def _tier_profile(pkg):
    """A Che tier profile (Zipf 0.9 over 128 keys, 3 shards), built by
    ``pkg`` (the reference's ``repro.hierarchy`` or the port's)."""
    from repro.cluster import zipf_key_probs

    probs = zipf_key_probs(128, 0.9, seed=0)
    return pkg.tiered_profile(probs, np.array([2, 8, 32, 96]), l2_cap=16,
                              assign=np.arange(128) % 3, n_shards=3)


@pytest.mark.parametrize("kw", [
    dict(tiers=2),
    dict(tiers=2, coalesce_flows=8),
    dict(tiers=3, n_shards=3, profile=True),
    dict(tiers=3, n_shards=3, profile=True, coalesce_flows=4, cores=16),
])
def test_hierarchy_forecast_equals_the_reference(models, kw):
    """``forecast_network(tiers > 0)``: the composed hierarchy of this
    pod's measured network (and, with ``coalesce_flows``, its cross-tier
    coalescing transform) is the reference's — stations, branches and their
    probabilities, bounds and p* to rtol 1e-12 — with the default constant
    tier profile and with a Che profile (the reference's type for the
    reference, the port's for the port, from the same keys)."""
    import repro.hierarchy as jhier
    import repro_torch.hierarchy as thier

    reqs = zipf_request_stream(10, n_prefixes=4, prefix_len=16,
                               vocab=models[1].vocab, seed=4, new_tokens=4)
    jeng, teng, _, _ = _serve_both(models, reqs, max_seqs=2,
                                   max_new_tokens=4, disk_servers=4)
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("profile", False):
        jkw.pop("profile")
        tkw.pop("profile")
        jkw["tier_profile"] = _tier_profile(jhier)
        tkw["tier_profile"] = _tier_profile(thier)
    want = jeng.forecast_network(step_us=6000.0, prefill_us=40.0, **jkw)
    got = teng.forecast_network(step_us=6000.0, prefill_us=40.0, **tkw)
    got.validate()
    # the coalesced transform solves a fixed point per p: fewer points
    grid = (0.0, 0.3, 0.7, 0.95) if "coalesce_flows" not in kw else (0.6,)
    pstar = 2001 if "coalesce_flows" not in kw else 21
    a = _net_summary(got, grid=grid, pstar_grid=pstar)
    b = _net_summary(want, grid=grid, pstar_grid=pstar)
    assert a.pop("p_star") == pytest.approx(b.pop("p_star"), rel=1e-12,
                                            abs=1e-15)
    np.testing.assert_allclose(a.pop("upper"), b.pop("upper"), rtol=1e-12)
    for (sa, *ra), (sb, *rb) in zip(a.pop("stations"), b.pop("stations")):
        assert [sa] + ra[:-1] == [sb] + rb[:-1]
        np.testing.assert_allclose(ra[-1], rb[-1], rtol=1e-12)
    for (na, va, pa), (nb, vb, pb) in zip(a.pop("branches"),
                                          b.pop("branches")):
        assert (na, va) == (nb, vb)
        np.testing.assert_allclose(pa, pb, rtol=1e-12, atol=1e-15)
    assert a == b


def test_cluster_forecast_equals_the_reference(models):
    """``ServeConfig.n_shards`` and a skewed ``shard_profile``: the composed
    cluster network is the reference's (the reference's profile type for
    the reference, the port's for the port, from the same placement)."""
    import repro.cluster as jcluster
    import repro_torch.cluster as tcluster

    reqs = zipf_request_stream(10, n_prefixes=4, prefix_len=16,
                               vocab=models[1].vocab, seed=4, new_tokens=4)
    jeng, teng, _, _ = _serve_both(models, reqs, max_seqs=2,
                                   max_new_tokens=4, n_shards=3)
    want = jeng.forecast_network(step_us=6000.0, prefill_us=40.0)
    got = teng.forecast_network(step_us=6000.0, prefill_us=40.0)
    a, b = _net_summary(got), _net_summary(want)
    assert a.pop("p_star") == pytest.approx(b.pop("p_star"), abs=1e-12)
    np.testing.assert_allclose(a.pop("upper"), b.pop("upper"), rtol=1e-12)
    assert a == b and got.name.endswith("cluster3")
    probs = jcluster.zipf_key_probs(512, 1.0, seed=0)
    assign = jcluster.HashRing(4, seed=1).assignment(512)
    want = jeng.forecast_network(
        step_us=6000.0, prefill_us=40.0, n_shards=4,
        shard_profile=jcluster.ideal_shard_profile(assign, probs))
    got = teng.forecast_network(
        step_us=6000.0, prefill_us=40.0, n_shards=4,
        shard_profile=tcluster.ideal_shard_profile(assign, probs))
    a, b = _net_summary(got), _net_summary(want)
    assert a.pop("p_star") == pytest.approx(b.pop("p_star"), abs=1e-12)
    np.testing.assert_allclose(a.pop("upper"), b.pop("upper"), rtol=1e-12)
    for (sa, *ra), (sb, *rb) in zip(a.pop("stations"), b.pop("stations")):
        assert [sa] + ra[:-1] == [sb] + rb[:-1]
        np.testing.assert_allclose(ra[-1], rb[-1], rtol=1e-12)
    for (na, va, pa), (nb, vb, pb) in zip(a.pop("branches"),
                                          b.pop("branches")):
        assert (na, va) == (nb, vb)
        np.testing.assert_allclose(pa, pb, rtol=1e-12, atol=1e-15)
    assert a == b


def test_admission_sketch_equals_the_reference(models):
    """``ServeConfig(sketch_cap=64)`` on ``launch/serve.py``'s stream (24
    requests over 4 prefixes of 24 tokens): the same tokens and stats as
    the JAX ``Engine``, and the same admission-stream sketch — the
    telemetry's streaming summary and alarms, ``observed_profile`` (rtol
    1e-12) and the SLO forecast it feeds by default."""
    reqs = zipf_request_stream(24, 4, 24, models[1].vocab, seed=0,
                               new_tokens=6)
    jeng, teng, jrs, trs = _serve_both(
        models, reqs, max_seqs=4, max_seq_len=256, page_size=8, n_pages=128,
        prefix_capacity=64, max_new_tokens=8, sketch_cap=64)
    assert [r.out for r in trs] == [r.out for r in jrs]
    assert teng.stats() == jeng.stats()
    tel, jtel = teng.telemetry(), jeng.telemetry()
    assert tel["streaming"] == jtel["streaming"]
    assert tel["alarms"] == jtel["alarms"]
    assert tel["streaming"]["key_count"] > 0
    got, want = teng.observed_profile(), jeng.observed_profile()
    for f in dataclasses.fields(want):
        np.testing.assert_allclose(np.asarray(getattr(got, f.name), float),
                                   np.asarray(getattr(want, f.name), float),
                                   rtol=1e-12, err_msg=f.name)
    args = dict(step_us=6000.0, prefill_us=40.0, arrival_rate=0.002,
                slo_us=5e4)
    fc, jfc = teng.forecast_slo(**args), jeng.forecast_slo(**args)
    assert fc.cap_grid is not None
    np.testing.assert_allclose(fc.cap_grid, jfc.cap_grid, rtol=1e-12)
    np.testing.assert_allclose(fc.p_grid, jfc.p_grid, rtol=1e-12)
    assert fc.p_star_slo == pytest.approx(jfc.p_star_slo, rel=1e-12)
