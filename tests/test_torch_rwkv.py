"""The port's rwkv6 family against ``repro.models`` and ``repro.serving``.

The JAX reference's parameters for the reduced rwkv6 configuration go
through ``convert.transformer_params_from_numpy`` into the port, and the
same numpy tokens through both sides' ``forward`` and ``decode_step``;
the WKV scan runs as the kernel's plain version on the CPU.

Tolerance: logits agree within 1e-4 of their largest magnitude, the model
tests' limit.  The reference's stacked-layer initialisation makes this
reduced model's residual stream ~1e6 and its WKV state ~1e12, so float32
rounding alone moves the logits by ~6e-5 of their scale (the port's scan
run in float64 instead of float32, everything else unchanged).

The port's ``Engine`` must serve the same tokens and end with the same
``stats()`` as the JAX ``Engine``: on the reference's repeated-prompt
scenario, on Zipf streams, and on a prompt pair whose state snapshot is
restored by a prompt with another tail (the reference keys the snapshot by
the last full page but stores the state after ``len - 1`` tokens; the port
reproduces it, ROADMAP queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import transformer as jt
from repro.models.layers import param_values
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels import linear_scan as tscan
from repro_torch.models import transformer as tt
from repro_torch.models.rwkv import RWKVState
from repro_torch.serving import Engine, ServeConfig, kv_pages
from repro_torch.training.data import zipf_request_stream

ARCH = "rwkv6-7b"
RTOL_SCALE = 1e-4


def _close(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    scale = np.abs(want).max() if scale is None else scale
    assert err <= RTOL_SCALE * scale, (err, scale)


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = param_values(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                       cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)


def test_forward_matches_reference(model):
    jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 2, 40)
    want = jt.forward(jp, jnp.asarray(toks), jcfg)[0]
    before = tscan.wkv6_scan.launches
    got, caches, _ = tt.forward(tp, torch.from_numpy(toks), cfg, device="cpu")
    assert tscan.wkv6_scan.launches == before  # the plain version on the CPU
    assert caches is None and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_prefill_then_decode_matches_reference(model):
    """Prefill 10 tokens into the state caches, then three decode steps:
    logits and every state leaf equal the reference's."""
    jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 2, 13, seed=2)
    jc = jt.init_cache(jcfg, 2, 32)
    tc = tt.init_cache(cfg, 2, 32, device="cpu")
    assert isinstance(tc[0][0], RWKVState)
    jl, jc, _ = jt.forward(jp, jnp.asarray(toks[:, :10]), jcfg, caches=jc,
                           cache_len=jnp.zeros((2,), jnp.int32))
    tl, tc2, _ = tt.forward(tp, torch.from_numpy(toks[:, :10]), cfg,
                            caches=tc, cache_len=[0, 0], device="cpu")
    assert tc2[0][0] is tc[0][0]  # updated in place
    _close(tl.numpy(), jl)
    for s in range(10, 13):
        lens = np.full((2,), s, np.int32)
        jl, jc = jt.decode_step(jp, jnp.asarray(toks[:, s:s + 1]), jc,
                                jnp.asarray(lens), jcfg)
        tl, tc = tt.decode_step(tp, torch.from_numpy(toks[:, s:s + 1]), tc,
                                torch.from_numpy(lens), cfg, device="cpu")
        _close(tl.numpy(), jl)
    for jstage, tstage in zip(jc, tc):
        for jst, tst in zip(jstage, tstage):
            for name in RWKVState._fields:
                a, b = getattr(tst, name), np.asarray(getattr(jst, name))
                assert tuple(a.shape) == b.shape and a.dtype == torch.float32
                _close(a.numpy(), b)


def test_prefill_and_decode_equal_one_forward(model):
    """The recurrent path: prefill 20 tokens, then 4 single-token decode
    steps; the last logits equal one 24-token forward's."""
    _, cfg, _, tp = model
    toks = torch.from_numpy(_tokens(cfg, 1, 24, seed=3))
    want = tt.forward(tp, toks, cfg, device="cpu")[0][:, -1]
    caches = tt.init_cache(cfg, 1, 32, device="cpu")
    tt.forward(tp, toks[:, :20], cfg, caches=caches, cache_len=[0],
               device="cpu")
    for s in range(20, 24):
        got, caches = tt.decode_step(tp, toks[:, s:s + 1], caches, [s], cfg,
                                     device="cpu")
    _close(got[:, 0].numpy(), want.numpy())


def test_params_convert_keeps_the_rwkv_tree():
    """A bfloat16 reference tree converts bit for bit, the unused ln1/ln2
    included; ``init_params`` draws the same tree shapes."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              param_dtype="bfloat16")
    jp = jax.tree_util.tree_map(
        np.asarray, param_values(jt.init_params(jcfg, jax.random.PRNGKey(1))))
    tp = transformer_params_from_numpy(jp, cfg, device="cpu")
    block = tp["stages"][0][0]
    assert set(block) == {"ln1", "rwkv", "ln2"}
    for name in ("wr", "u", "lora_a_w", "ffn_v"):
        a, b = block["rwkv"][name], jp["stages"][0][0]["rwkv"][name]
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32))
    assert block["rwkv"]["ln_x"].dtype == torch.float32
    ours = tt.init_params(cfg, seed=0, device="cpu")
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), ours)
    assert tshapes == jax.tree_util.tree_map(lambda x: x.shape, jp)


def test_init_keeps_the_residual_finite_at_full_depth():
    """rwkv6-7b's 32 layers at a narrow width: the port's initialisation
    (residual-writing projections scaled by 1/sqrt(2 L)) keeps the un-normed
    residual stream finite and of order one."""
    cfg = dataclasses.replace(get_config(ARCH), d_model=128, d_ff=448,
                              vocab=128, param_dtype="float32",
                              compute_dtype="float32")
    assert cfg.n_layers == 32
    tp = tt.init_params(cfg, seed=0, device="cpu")
    logits = tt.forward(tp, _tokens(cfg, 1, 16), cfg, device="cpu")[0]
    assert torch.isfinite(logits).all()
    assert float(logits.abs().max()) < 1e3


def test_full_width_rwkv6_config():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff,
            cfg.vocab) == (32, 4096, 64, 14336, 65536)
    assert cfg.param_count() == 7_558_664_192


# ---------------------------------------------------------------------------
# Serving: state snapshots
# ---------------------------------------------------------------------------


def _serve_both(model, prompts, **kw):
    """Both engines on the same prompts, submitted in one batch (or in
    waves: a list of lists, each run to the end before the next)."""
    jcfg, cfg, jp, tp = model
    serve = dict(max_seqs=3, max_seq_len=128, page_size=8, n_pages=32,
                 prefix_capacity=24, policy="lru", max_new_tokens=5)
    serve.update(kw)
    jeng = JEngine(jcfg, jp, JServeConfig(**serve))
    teng = Engine(cfg, tp, ServeConfig(**serve), device="cpu")
    waves = prompts if isinstance(prompts[0], list) else [prompts]
    jrs, trs = [], []
    for wave in waves:
        jrs += [jeng.submit(t) for t in wave]
        trs += [teng.submit(t) for t in wave]
        jeng.run()
        teng.run()
    return jeng, teng, jrs, trs


def _assert_same(jeng, teng, jrs, trs):
    assert [r.out for r in trs] == [r.out for r in jrs]
    assert [(r.prefill_tokens_computed, r.prefill_tokens_skipped)
            for r in trs] == [(r.prefill_tokens_computed,
                               r.prefill_tokens_skipped) for r in jrs]
    assert teng.stats() == jeng.stats()
    assert teng.ticks == jeng.ticks
    assert (teng.telemetry()["metrics"]["counters"]
            == jeng.telemetry()["metrics"]["counters"])


def test_engine_repeated_prompt_equals_the_reference(model):
    """The reference's scenario (tests/test_serving.py): one 16-token prompt
    twice; the snapshot covers 15 tokens and the last is re-run."""
    prompt = (np.arange(16) * 3) % model[1].vocab
    jeng, teng, jrs, trs = _serve_both(
        model, [[prompt], [prompt]], max_seqs=2, max_seq_len=64, n_pages=16,
        prefix_capacity=8, max_new_tokens=4)
    _assert_same(jeng, teng, jrs, trs)
    assert (trs[1].prefill_tokens_skipped, trs[1].prefill_tokens_computed) \
        == (15, 1)
    assert trs[1].out == trs[0].out
    assert teng.layer_pools() == []


@pytest.mark.parametrize("policy,kw", [
    ("lru", {}),
    ("s3fifo", dict(n_pages=4, prefix_capacity=2)),  # evicting
])
def test_engine_zipf_stream_equals_the_reference(model, policy, kw):
    """Whole-prefix prompts (new_tokens=0, 16 tokens on 8-token pages): every
    hit restores a snapshot of the same prompt."""
    reqs = zipf_request_stream(10, n_prefixes=4, prefix_len=16,
                               vocab=model[1].vocab, seed=1, new_tokens=0)
    jeng, teng, jrs, trs = _serve_both(model, [t for _, t in reqs],
                                       policy=policy, **kw)
    _assert_same(jeng, teng, jrs, trs)
    assert teng.stats()["chunk_hit_ratio"] > 0
    assert teng.stats()["evictions"] > 0 or policy == "lru"
    for r in trs:
        assert r.prefill_tokens_skipped in (0, len(r.tokens) - 1)


def test_engine_restores_another_tail_as_the_reference(model):
    """Two prompts share a 16-token prefix and differ in their 5-token
    tails, on 8-token pages: the second restores the first's snapshot (its
    state after 20 tokens, the first's tail included) and skips 20 tokens,
    in both engines alike."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, model[1].vocab, 16)
    a, b = (np.concatenate([prefix, rng.integers(0, model[1].vocab, 5)])
            for _ in range(2))
    jeng, teng, jrs, trs = _serve_both(model, [[a], [b]], max_new_tokens=6)
    _assert_same(jeng, teng, jrs, trs)
    assert trs[1].prefill_tokens_skipped == 20


def test_engine_outputs_identical_with_and_without_the_cache(model):
    """On whole-prefix prompts a hit restores the same prompt's state: the
    tokens equal those served with the controller bypassed."""
    _, cfg, _, tp = model
    reqs = zipf_request_stream(8, n_prefixes=3, prefix_len=16,
                               vocab=cfg.vocab, seed=2, new_tokens=0)
    outs = []
    for bypass in (0.0, 1.0):
        eng = Engine(cfg, tp, ServeConfig(
            max_seqs=3, max_seq_len=64, page_size=8, n_pages=16,
            prefix_capacity=8, bypass_fraction=bypass, max_new_tokens=4),
            device="cpu")
        rs = [eng.submit(t) for _, t in reqs]
        eng.run()
        outs.append([r.out for r in rs])
        if not bypass:
            assert eng.prefix.stats.chunk_hits > 0
    assert outs[0] == outs[1]


def test_state_pool_holds_snapshots(model):
    """The pool keeps one snapshot of every state leaf per page, and a page
    holds the state a fresh prefill of the prompt's first len-1 tokens
    computes."""
    _, cfg, _, tp = model
    prompt = (np.arange(16) * 5) % cfg.vocab
    eng = Engine(cfg, tp, ServeConfig(max_seqs=2, max_seq_len=64, page_size=8,
                                      n_pages=16, prefix_capacity=8,
                                      max_new_tokens=2), device="cpu")
    pool = eng.pool[0][0]
    assert isinstance(pool, RWKVState)
    g, D = cfg.n_layers, cfg.d_model
    H, dh = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert tuple(pool.wkv.shape) == (g, 16, H, dh, dh)
    assert tuple(pool.x_prev_att.shape) == (g, 16, D)
    eng.submit(prompt)
    eng.run()
    page = next(iter(eng.prefix.pages.values()))
    fresh = tt.init_cache(cfg, 1, 64, device="cpu")
    tt.forward(tp, prompt[None, :15], cfg, caches=fresh, cache_len=[0],
               device="cpu")
    for name in RWKVState._fields:
        np.testing.assert_array_equal(getattr(pool, name)[:, page].numpy(),
                                      getattr(fresh[0][0], name)[:, 0].numpy())
    back = tt.init_cache(cfg, 1, 64, device="cpu")
    for p_leaf, c_leaf in zip(pool, back[0][0]):
        kv_pages.restore_state(c_leaf, p_leaf, 0, page)
    for a, b in zip(back[0][0], fresh[0][0]):
        assert torch.equal(a, b)
