"""The port's dense decoder against ``repro.models.transformer``.

The JAX reference's parameters (``init_params`` on a PRNG key, mapped to
numpy) go through ``convert.transformer_params_from_numpy`` into the port,
and the same numpy tokens through both ``forward`` and ``decode_step``, for
three reduced configurations: internlm2 (GQA), qwen3 (qk-norm) and gemma3
(5 local : 1 global, tied embeddings), with ``use_pallas`` off and on.

Tolerance: logits agree within 1e-4 of their largest magnitude.  Both sides
compute in float32; against a float64 run of the port, the reference's
logits and the port's are each off by up to ~4e-5 of that magnitude on
these reduced models (the reference's stacked-layer initialisation scales
weights by ``1/sqrt(n_layers)``, which makes the logits large), so the two
agree to float32 rounding, not bit for bit.
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
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import layers as L
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig

DENSE = ["internlm2-1.8b", "qwen3-32b", "gemma3-27b"]
RTOL_SCALE = 1e-4


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL_SCALE * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    arch = request.param
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = param_values(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = transformer_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                       cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_reference(model, use_pallas):
    jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 2, 40)
    want = jt.forward(jp, jnp.asarray(toks), jcfg, use_pallas=use_pallas)[0]
    got, caches, aux = tt.forward(tp, torch.from_numpy(toks), cfg,
                                  use_pallas=use_pallas, device="cpu")
    assert caches is None and got.dtype == torch.float32
    assert float(aux["moe_aux_loss"]) == 0.0
    _close(got.numpy(), want)


def test_forward_unembed_last_only(model):
    jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 1, 9, seed=1)
    want = jt.forward(jp, jnp.asarray(toks), jcfg, unembed_last_only=True)[0]
    got = tt.forward(tp, toks, cfg, unembed_last_only=True, device="cpu")[0]
    assert got.shape == (1, 1, cfg.vocab)
    _close(got.numpy(), want)


def test_prefill_then_decode_matches_reference(model):
    """Prefill 10 tokens into a cache, then three decode steps: logits and
    the caches' K/V and indices equal the reference's."""
    jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 2, 13, seed=2)
    jc = jt.init_cache(jcfg, 2, 32)
    tc = tt.init_cache(cfg, 2, 32, device="cpu")
    jl, jc, _ = jt.forward(jp, jnp.asarray(toks[:, :10]), jcfg, caches=jc,
                           cache_len=jnp.zeros((2,), jnp.int32))
    tl, tc, _ = tt.forward(tp, torch.from_numpy(toks[:, :10]), cfg, caches=tc,
                           cache_len=[0, 0], device="cpu")
    _close(tl.numpy(), jl)
    for s in range(10, 13):
        lens = np.full((2,), s, np.int32)
        jl, jc = jt.decode_step(jp, jnp.asarray(toks[:, s:s + 1]), jc,
                                jnp.asarray(lens), jcfg, use_pallas=True)
        tl, tc = tt.decode_step(tp, torch.from_numpy(toks[:, s:s + 1]), tc,
                                torch.from_numpy(lens), cfg, use_pallas=True,
                                device="cpu")
        _close(tl.numpy(), jl)
    for jstage, tstage in zip(jc, tc):
        for jkv, tkv in zip(jstage, tstage):
            np.testing.assert_array_equal(tkv.index.numpy(),
                                          np.asarray(jkv.index))
            assert tkv.k.shape == jkv.k.shape
            np.testing.assert_allclose(tkv.k.numpy(), np.asarray(jkv.k),
                                       rtol=1e-4, atol=1e-4)


def test_use_pallas_launches_nothing_on_the_cpu(model):
    """On CPU tensors the flash wrapper runs its plain version: no kernel
    launch is counted."""
    _, cfg, _, tp = model
    before = tflash.flash_attention.launches
    tt.forward(tp, _tokens(cfg, 1, 8), cfg, use_pallas=True, device="cpu")
    assert tflash.flash_attention.launches == before


def test_params_convert_keeps_layout_and_dtype():
    """A bfloat16 reference tree converts bit for bit, stage axes first."""
    jcfg = jget_config("gemma3-27b", reduced=True)
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("gemma3-27b", reduced=True),
                              param_dtype="bfloat16")
    jp = jax.tree_util.tree_map(
        np.asarray, param_values(jt.init_params(jcfg, jax.random.PRNGKey(1))))
    tp = transformer_params_from_numpy(jp, cfg, device="cpu")
    assert "unembed" not in tp  # tied
    assert [len(s) for s in tp["stages"]] == [len(p) for _, p in
                                              tt.build_stages(cfg)]
    wq_j = jp["stages"][0][0]["attn"]["wq"]
    wq_t = tp["stages"][0][0]["attn"]["wq"]
    assert wq_t.dtype == torch.bfloat16 and wq_t.shape == wq_j.shape
    np.testing.assert_array_equal(wq_t.float().numpy(), wq_j.astype(np.float32))
    assert tp["final_norm"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="stages"):
        transformer_params_from_numpy({**jp, "stages": jp["stages"] * 2}, cfg,
                                      device="cpu")


def test_init_params_shapes_and_seed():
    cfg = get_config("internlm2-1.8b", reduced=True)
    a = tt.init_params(cfg, seed=3, device="cpu")
    b = tt.init_params(cfg, seed=3, device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda x: x.shape,
        param_values(jt.init_params(jget_config("internlm2-1.8b", reduced=True),
                                    jax.random.PRNGKey(0), abstract=True)))
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), a)
    assert tshapes == jshapes
    assert torch.equal(a["stages"][0][0]["attn"]["wq"],
                       b["stages"][0][0]["attn"]["wq"])
    n = sum(x.numel() for x in jax.tree_util.tree_leaves(a))
    assert n == cfg.param_count()


def test_full_width_internlm2_config():
    cfg = get_config("internlm2-1.8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab) == (24, 2048, 16, 8, 128, 8192,
                                                 92544)
    assert abs(cfg.param_count() - 1.89e9) < 0.01e9
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config("internlm2-1.8b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_the_reference(arch):
    for reduced in (False, True):
        got = dataclasses.asdict(get_config(arch, reduced=reduced))
        want = dataclasses.asdict(jget_config(arch, reduced=reduced))
        assert got == want


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "zamba2-1.2b",
                                  "whisper-tiny", "arctic-480b"])
def test_unported_families_raise(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.init_params(cfg, device="cpu")


def test_layers_match_reference_arithmetic():
    """gelu is the tanh approximation, RoPE rotates split halves, rms_norm
    upcasts with eps 1e-6."""
    import repro.models.layers as JL

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-6)
    for act in ("swiglu", "geglu", "sqrelu", "gelu"):
        p = {k: rng.standard_normal(s).astype(np.float32) / 4 for k, s in
             (("gate", (16, 24)), ("up", (16, 24)), ("down", (24, 16)))}
        np.testing.assert_allclose(
            L.mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                        for k, v in p.items()}, act).numpy(),
            np.asarray(JL.mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                               for k, v in p.items()}, act)),
            rtol=2e-5, atol=2e-5)


def test_forward_runs_where_its_parameters_are():
    """Tokens may be any int array; parameters on the CPU with the default
    device (the card) raise rather than run quietly on the CPU."""
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=1, d_ff=32, vocab=32, d_head=8,
                      param_dtype="float32", compute_dtype="float32")
    tp = tt.init_params(cfg, device="cpu")
    logits, _, _ = tt.forward(tp, [[1, 2, 3]], cfg, device="cpu")
    assert logits.shape == (1, 3, 32)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="parameters on cpu"):
            tt.forward(tp, [[1, 2, 3]], cfg)
