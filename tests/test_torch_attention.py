"""The port's attention against the JAX package's, on the same inputs.

Numpy arrays from one seed go through ``repro.kernels.ref`` (the jnp
oracles of the Pallas kernels), one interpret-mode call each of
``repro.kernels.ops``, ``repro.models.attention`` and their counterparts
in the port: the flash and paged plain versions (what the kernel wrappers
run on CPU tensors), ``chunked_attention`` and ``attention`` in its three
modes.  Tolerances are the reference's own (``tests/test_kernels.py``):
2e-5 in float32, 2e-2 in bfloat16.  The tensor-core flash kernel's plain
version (bf16 at d_head 64/128) is also held to a direct einsum of its
arithmetic, within 1e-6; the split-TF32 kernel's (every other width) is
held at d_head 80 and 168 (qwen3-32b's, gemma3-27b's) to the jnp oracle
and to the Pallas kernel in interpret mode.  The CUDA kernels are held against
their plain versions in ``tests/test_torch_attention_cuda.py``, on the
card.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpaged
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig

F32, BF16 = "float32", "bfloat16"
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}

# tests/test_kernels.py's FLASH_CASES and PAGED_CASES
FLASH_CASES = [
    # (B, T, S, H, KV, dh, causal, window, dtype)
    (1, 128, 128, 4, 4, 64, True, 0, F32),
    (2, 256, 256, 4, 2, 64, True, 0, F32),
    (1, 128, 128, 8, 2, 128, True, 0, BF16),
    (1, 256, 256, 4, 4, 64, True, 128, F32),  # sliding window
    (2, 64, 192, 4, 2, 64, False, 0, F32),  # bidir, ragged blocks
    (1, 100, 100, 2, 2, 64, True, 0, F32),  # non-multiple of block
]
PAGED_CASES = [
    # (B, H, KV, dh, page, n_pages, P, dtype)
    (2, 4, 2, 64, 16, 4, 16, F32),
    (3, 8, 8, 64, 32, 3, 12, F32),
    (2, 4, 4, 128, 16, 2, 8, BF16),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == BF16 else dict(rtol=2e-5,
                                                                 atol=2e-5)


def _both(a, dtype):
    """One numpy array as a JAX array and a CPU tensor of ``dtype``."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def flash_inputs(case, seed=0):
    B, T, S, H, KV, dh, causal, window, dtype = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, dh), dtype=np.float32)
    return [_both(a, dtype) for a in (q, k, v)]


def paged_inputs(case, seed=0, seq_lens=None):
    B, H, KV, dh, page, n_pages, P, dtype = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh), dtype=np.float32)
    pk = rng.standard_normal((P, page, KV, dh), dtype=np.float32)
    pv = rng.standard_normal((P, page, KV, dh), dtype=np.float32)
    bt = rng.permutation(P)[: B * n_pages].reshape(B, n_pages).astype(np.int32)
    if seq_lens is None:
        seq_lens = rng.integers(1, n_pages * page + 1, B)
    sl = np.asarray(seq_lens, np.int32)
    arrays = [_both(a, dtype) for a in (q, pk, pv)]
    return arrays + [(jnp.asarray(bt), torch.from_numpy(bt)),
                     (jnp.asarray(sl), torch.from_numpy(sl))]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_ref(case):
    causal, window, dtype = case[6], case[7], case[8]
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case)
    want = jref.flash_attention_ref(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                    jv.swapaxes(1, 2), causal=causal,
                                    window=window).swapaxes(1, 2)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_flash_plain_matches_interpret_kernel():
    """One interpret-mode run of the Pallas kernel (the reference's slow
    path): the (1, 100, 100, 2, 2, 64) case, ragged against its tiles."""
    case = FLASH_CASES[-1]
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, seed=1)
    want = jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64,
                                interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(F32))


def test_flash_fully_masked_window_tiles_are_wiped():
    """Rows whose first tiles are all masked (window 8 at T = 200): the
    finite NEG_INF sums those tiles with weight one and the first valid
    tile zeroes them, so the result equals the dense reference."""
    case = (1, 200, 200, 2, 1, 16, True, 8, F32)
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, seed=2)
    want = jref.flash_attention_ref(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                    jv.swapaxes(1, 2), causal=True,
                                    window=8).swapaxes(1, 2)
    got = tflash.flash_attention_plain(tq, tk, tv, causal=True, window=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(F32))


def test_flash_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 12, 2, 16)
    with pytest.raises(ValueError, match="T == S"):
        ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), k.double(), causal=False)
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 12, 3, 16).contiguous(),
                            k[:, :, :1].expand(1, 12, 3, 16).contiguous(),
                            causal=False)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, causal=True, window=-1)


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic (bf16 at d_head 64/128) and the
# wrapper's (dtype, d_head) dispatch
# ---------------------------------------------------------------------------

# one K/V tile (S <= the kernel's 128 columns): the online softmax is a
# plain softmax, so a direct einsum is the same arithmetic
TC_ONE_TILE = [
    # (B, T, S, H, KV, causal, window)
    (1, 100, 100, 4, 2, True, 0),
    (2, 96, 128, 2, 1, False, 0),
    (1, 128, 128, 2, 2, True, 16),
]
# several tiles, ragged, windowed and bidirectional, against the reference
TC_CASES = [
    (1, 300, 300, 4, 2, 128, True, 0, BF16),
    (1, 300, 300, 4, 2, 64, True, 0, BF16),
    (1, 256, 256, 4, 4, 64, True, 100, BF16),
    (2, 64, 192, 4, 2, 128, False, 0, BF16),
]


def _direct_tensor_core_attention(q, k, v, causal, window):
    """Softmax attention in one shot with the tensor-core kernel's
    arithmetic: unscaled float32 dot of the bf16 inputs, scale after, p
    rounded to bf16 for P V, l summed from the float32 p."""
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kf) * torch.tensor(
        dh**-0.5, dtype=torch.float32)
    rows, cols = torch.arange(T)[:, None], torch.arange(S)[None, :]
    valid = torch.ones(T, S, dtype=torch.bool)
    if causal:
        valid &= cols <= rows
    if window:
        valid &= cols > rows - window
    logits = logits.masked_fill(~valid, tattn.NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhts,bshd->bthd", p.to(torch.bfloat16).float(), vf)
    return out / p.sum(dim=-1).transpose(1, 2)[..., None]


@pytest.mark.parametrize("dh", tflash.TC_HEAD_DIMS)
@pytest.mark.parametrize("case", TC_ONE_TILE)
def test_flash_tensor_core_plain_is_its_arithmetic(case, dh):
    B, T, S, H, KV, causal, window = case
    (_, tq), (_, tk), (_, tv) = flash_inputs(
        (B, T, S, H, KV, dh, causal, window, BF16), seed=10)
    got = tflash.tensor_core_plain(tq, tk, tv, causal, window)
    want = _direct_tensor_core_attention(tq, tk, tv, causal, window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, got.to(torch.bfloat16))


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_tensor_core_plain_matches_ref(case):
    causal, window = case[6], case[7]
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, seed=11)
    want = jref.flash_attention_ref(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                    jv.swapaxes(1, 2), causal=causal,
                                    window=window).swapaxes(1, 2)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(BF16))


def test_flash_mean_criterion_sees_a_dropped_tile():
    """``chip_smoke.py`` holds the tensor-core kernel to mean |kernel -
    plain| <= 5e-3 mean |plain|.  Rounding p to bf16 (against the same
    tiles with float32 p, both outputs in bf16) stays well inside it; 64
    keys of 2048 left out of the sum fall far outside."""
    case = (1, 64, 2048, 2, 1, 128, False, 0, BF16)
    (_, tq), (_, tk), (_, tv) = flash_inputs(case, seed=12)
    plain = tflash.flash_attention_plain(tq, tk, tv, False, 0)
    p_f32 = tflash.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                         False, 0).to(torch.bfloat16)
    keep = torch.cat([torch.arange(1024), torch.arange(1088, 2048)])
    dropped = tflash.flash_attention_plain(tq, tk[:, keep], tv[:, keep],
                                           False, 0)

    def mean_rel(a):
        return float((a.float() - plain.float()).abs().mean()
                     / plain.float().abs().mean())

    assert mean_rel(p_f32) < 5e-3 / 2
    assert mean_rel(dropped) > 5e-3 * 2


@pytest.mark.parametrize("dh", [16, 80, 168])
def test_flash_mean_criterion_sees_a_dropped_split_tile(dh):
    """``chip_smoke.py`` holds every bf16 case of the split-TF32 kernel to
    the same mean criterion.  Its bf16 inputs are exact in TF32, so what it
    may differ by is the plain version's float32 rounding: the same
    attention in float64 rounded to bf16 stays far inside 5e-3; one of the
    kernel's K/V tiles (64 keys, or 32 at d_head 168) left out of 2048
    falls far outside."""
    case = (1, 64, 2048, 4, 2, dh, False, 0, BF16)
    (_, tq), (_, tk), (_, tv) = flash_inputs(case, seed=12)
    plain = tflash.flash_attention_plain(tq, tk, tv, False, 0)
    qd = tq.double().reshape(1, 64, 2, 2, dh) * dh**-0.5
    p = torch.softmax(torch.einsum("btkgd,bskd->btkgs", qd, tk.double()), -1)
    f64 = torch.einsum("btkgs,bskd->btkgd", p, tv.double()).reshape(
        tq.shape).to(torch.bfloat16)
    bk = tflash.split_tf32_cols(dh)
    keep = torch.cat([torch.arange(2 * bk), torch.arange(3 * bk, 2048)])
    dropped = tflash.flash_attention_plain(tq, tk[:, keep], tv[:, keep],
                                           False, 0)

    def mean_rel(a):
        return float((a.float() - plain.float()).abs().mean()
                     / plain.float().abs().mean())

    assert mean_rel(f64) < 5e-3 / 2
    assert mean_rel(dropped) > 5e-3 * 2


@pytest.mark.parametrize("dtype,dh,kind", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 16, "split_tf32"), (torch.bfloat16, 32, "split_tf32"),
    (torch.float32, 64, "split_tf32"), (torch.float32, 128, "split_tf32"),
    (torch.bfloat16, 80, "split_tf32"), (torch.bfloat16, 168, "split_tf32"),
    (torch.float32, 80, "split_tf32"), (torch.float16, 64, None),
    (torch.float32, 168, "split_tf32"), (torch.float32, 84, None),
    (torch.bfloat16, 100, None)])
def test_flash_kernel_for_dispatch(dtype, dh, kind):
    if kind is None:
        with pytest.raises(ValueError, match="no flash kernel"):
            tflash.kernel_for(dtype, dh)
    else:
        assert tflash.kernel_for(dtype, dh) == kind


class _FakeLibrary:
    """Both launchers, recording their calls and returning ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def flash_attention_sm90_launch(self, *args):
        self.calls.append("tensor_core")
        return self.err

    def flash_attention_launch(self, *args):
        self.calls.append("split_tf32")
        self.args = args
        return self.err


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("dtype,kind", [(torch.bfloat16, "tensor_core"),
                                        (torch.float32, "split_tf32")])
def test_flash_launch_takes_one_kernel_and_never_swaps(monkeypatch, dtype,
                                                       kind, err):
    """``launch`` calls the one kernel ``kernel_for`` names and counts it
    on ``flash_attention``; when it fails, it raises, counts nothing and no
    other kernel is tried."""
    lib = _FakeLibrary(err)
    monkeypatch.setattr(tflash._build, "load_library", lambda: lib)
    monkeypatch.setattr(tflash, "_on_card",
                        lambda device: contextlib.nullcontext(0))
    q = torch.zeros(1, 8, 2, 128, dtype=dtype)
    k = torch.zeros(1, 8, 1, 128, dtype=dtype)
    n0 = tflash.flash_attention.launches
    tc0 = tflash.flash_attention.tensor_core_launches
    if err:
        with pytest.raises(RuntimeError, match=f"cudaError_t {err}"):
            tflash.launch(q, k, k, True, 0)
    else:
        assert tflash.launch(q, k, k, True, 0).shape == q.shape
    assert lib.calls == [kind]
    launched = int(not err)  # counted where the kernel is queued, only then
    assert tflash.flash_attention.launches == n0 + launched
    assert tflash.flash_attention.tensor_core_launches == (
        tc0 + launched * (kind == "tensor_core"))


def test_flash_launch_aligns_the_split_tf32_inputs(monkeypatch):
    """The split-TF32 kernel copies 16-byte pieces by ``cp.async``: a view
    that starts 4 bytes into its storage is copied to an aligned tensor
    before the launch, as the tensor-core kernel's inputs are."""
    lib = _FakeLibrary(0)
    monkeypatch.setattr(tflash._build, "load_library", lambda: lib)
    monkeypatch.setattr(tflash, "_on_card",
                        lambda device: contextlib.nullcontext(0))
    base = torch.zeros(1 + 8 * 2 * 80)
    q = base[1:].view(1, 8, 2, 80)
    assert q.data_ptr() % 16
    n0 = tflash.flash_attention.launches
    tflash.launch(q, q, q, True, 0)
    assert lib.calls == ["split_tf32"]
    assert all(p % 16 == 0 for p in lib.args[1:5])
    assert tflash.flash_attention.launches == n0 + 1


# ---------------------------------------------------------------------------
# the split-TF32 kernel's new head widths: 80 (qwen3-32b) and 168
# (gemma3-27b), whose K/V tiles are 32 columns wide
# ---------------------------------------------------------------------------

SPLIT_WIDE_CASES = [
    # (B, T, S, H, KV, dh, causal, window, dtype)
    (1, 100, 100, 4, 2, 80, True, 0, F32),  # ragged T, GQA 2
    (1, 130, 130, 4, 1, 168, True, 0, F32),  # ragged, GQA 4, five tiles
    (1, 160, 160, 2, 2, 80, True, 40, F32),  # sliding window
    (1, 160, 160, 4, 2, 168, True, 40, F32),
    (2, 40, 96, 4, 2, 168, False, 0, F32),  # bidirectional, T != S
    (2, 40, 96, 8, 1, 80, False, 0, F32),  # GQA 8
    (1, 100, 100, 4, 2, 80, True, 0, BF16),
    (1, 130, 130, 2, 1, 168, True, 24, BF16),
    (2, 40, 96, 4, 4, 80, False, 0, BF16),
    (1, 100, 100, 4, 2, 168, True, 0, BF16),
]


@pytest.mark.parametrize("case", SPLIT_WIDE_CASES)
def test_flash_split_tf32_plain_matches_ref(case):
    causal, window, dtype = case[6], case[7], case[8]
    assert tflash.kernel_for(TDT[dtype], case[5]) == "split_tf32"
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, seed=13)
    want = jref.flash_attention_ref(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                    jv.swapaxes(1, 2), causal=causal,
                                    window=window).swapaxes(1, 2)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dh", [80, 168])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_split_tf32_plain_matches_interpret_kernel(dh, dtype, causal,
                                                         window):
    """The Pallas kernel in interpret mode (64 x 64 tiles) at the new
    widths: ragged T = S = 100, GQA 2."""
    case = (1, 100, 100, 4, 2, dh, causal, window, dtype)
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, seed=14)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                bq=64, bk=64, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dh", [80, 168])
def test_flash_fully_masked_window_tiles_are_wiped_at_new_widths(dh):
    """Window 8 at T = 200: a row past the first tile finds its first
    tiles wholly masked (tiles of 32 columns at d_head 168, of 64 at 80);
    the garbage they sum with weight one is zeroed by the first valid
    tile."""
    case = (1, 200, 200, 2, 1, dh, True, 8, F32)
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(case, seed=15)
    want = jref.flash_attention_ref(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                    jv.swapaxes(1, 2), causal=True,
                                    window=8).swapaxes(1, 2)
    got = tflash.flash_attention_plain(tq, tk, tv, causal=True, window=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(F32))


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

PAGED_EXTRA = [
    # seq_len 0 (uniform mean over the table's pages) and seq_len 1
    pytest.param(PAGED_CASES[0], [0, 37], id="seq_len0"),
    pytest.param(PAGED_CASES[2], [1, 1], id="seq_len1"),
    # 16 pages of 16 tokens: the kernel's 4, 3 and (seq_len 0) 4 steps
    pytest.param((3, 4, 2, 64, 16, 16, 64, F32), [256, 131, 0],
                 id="multi_step"),
]


@pytest.mark.parametrize("case,seq_lens",
                         [(c, None) for c in PAGED_CASES] + PAGED_EXTRA)
def test_paged_plain_matches_ref(case, seq_lens):
    dtype = case[-1]
    ins = paged_inputs(case, seq_lens=seq_lens)
    want = jref.paged_attention_ref(*[j for j, _ in ins])
    got = ops.paged_attention(*[t for _, t in ins])
    assert got.dtype == ins[0][1].dtype and got.shape == ins[0][1].shape
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_paged_seq_len0_is_the_uniform_mean():
    case = PAGED_CASES[0]
    ins = paged_inputs(case, seq_lens=[0, 0])
    q, pk, pv, bt, sl = [t for _, t in ins]
    got = ops.paged_attention(q, pk, pv, bt, sl)
    B, H, KV, dh, page, n = case[0], case[1], case[2], case[3], case[4], case[5]
    mean = pv[bt.long()].reshape(B, n * page, KV, dh).mean(dim=1)
    want = mean.repeat_interleave(H // KV, dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_paged_plain_matches_interpret_kernel():
    case = PAGED_CASES[0]
    ins = paged_inputs(case, seed=3)
    want = jops.paged_attention(*[j for j, _ in ins], interpret=True)
    got = ops.paged_attention(*[t for _, t in ins])
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(F32))


def test_paged_wrapper_rejects_bad_inputs():
    ins = [t for _, t in paged_inputs(PAGED_CASES[0])]
    q, pk, pv, bt, sl = ins
    with pytest.raises(ValueError, match="outside"):
        ops.paged_attention(q, pk, pv, bt + pk.shape[0], sl)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, pk, pv, bt.long(), sl)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.paged_attention(q.double(), pk, pv, bt, sl)


# ---------------------------------------------------------------------------
# chunked_attention and the attention block
# ---------------------------------------------------------------------------

CHUNKED_CASES = [
    # (B, T, S, H, KV, dh, causal, window, chunk, valid)
    (2, 1, 40, 4, 2, 16, True, 0, 1024, [13, 40]),   # decode: one shot
    (2, 24, 24, 4, 2, 16, True, 0, 1024, [24, 24]),  # prefill: one shot
    (1, 300, 300, 4, 1, 16, True, 0, 128, [300]),    # chunk scan, ragged
    (2, 200, 200, 4, 2, 16, True, 32, 128, [200, 150]),  # window, scan
    (2, 30, 50, 4, 4, 16, False, 0, 1024, [50, 21]),  # bidir
]


@pytest.mark.parametrize("case", CHUNKED_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_chunked_attention_matches_reference(case, dtype):
    B, T, S, H, KV, dh, causal, window, chunk, valid = case
    (jq, tq), (jk, tk), (jv, tv) = flash_inputs(
        (B, T, S, H, KV, dh, causal, window, dtype), seed=4)
    pos = np.broadcast_to(np.arange(S - T, S, dtype=np.int32), (B, T)).copy()
    lim = np.asarray(valid, np.int32)
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(pos),
                                   jnp.asarray(lim), causal, window, chunk)
    got = tattn.chunked_attention(tq, tk, tv, torch.from_numpy(pos),
                                  torch.from_numpy(lim), causal, window, chunk)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def _attn_params(cfg, seed=5):
    rng = np.random.default_rng(seed)
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": rng.standard_normal((D, H * dh)) / np.sqrt(D),
         "wk": rng.standard_normal((D, KV * dh)) / np.sqrt(D),
         "wv": rng.standard_normal((D, KV * dh)) / np.sqrt(D),
         "wo": rng.standard_normal((H * dh, D)) / np.sqrt(H * dh)}
    if cfg.qk_norm:
        p["q_norm"] = 1 + 0.1 * rng.standard_normal(dh)
        p["k_norm"] = 1 + 0.1 * rng.standard_normal(dh)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=64, d_head=8, local_window=6,
              param_dtype="float32", compute_dtype="float32")


@pytest.mark.parametrize("kind,qk_norm,use_pallas", [
    ("global", False, False), ("global", True, True), ("local", False, True),
    ("bidir", False, True)])
def test_attention_without_cache(kind, qk_norm, use_pallas):
    jcfg, tcfg = JConfig(**CFG_KW, qk_norm=qk_norm), ModelConfig(
        **CFG_KW, qk_norm=qk_norm)
    jp, tp = _attn_params(jcfg)
    x = np.random.default_rng(6).standard_normal((2, 20, 32)).astype(np.float32)
    want, _ = jattn.attention(jnp.asarray(x), jp, jcfg, kind)
    before = tflash.flash_attention.launches
    got, cache = tattn.attention(torch.from_numpy(x), tp, tcfg, kind,
                                 use_pallas=use_pallas)
    assert cache is None
    assert tflash.flash_attention.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_attention_prefill_then_decode_into_cache():
    """Prefill 7 tokens of each sequence into a cache, then decode two steps
    at per-sequence positions (one slot past its length, as an idle engine
    slot is); K/V, index and outputs equal the reference's."""
    jcfg, tcfg = JConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(7)
    S = 16
    jc = jattn.init_kv_cache(2, S, 2, 8, jnp.float32)
    tc = tattn.init_kv_cache(2, S, 2, 8, torch.float32, "cpu")
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    jo, jc = jattn.attention(jnp.asarray(x), jp, jcfg, "global",
                             jnp.asarray(pos), kv_cache=jc, use_pallas=True)
    to, tc = tattn.attention(torch.from_numpy(x), tp, tcfg, "global",
                             torch.from_numpy(pos), kv_cache=tc,
                             use_pallas=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
    for step in range(2):
        x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
        p1 = np.asarray([[7 + step], [3]], np.int32)
        jo, jc = jattn.attention(jnp.asarray(x1), jp, jcfg, "global",
                                 jnp.asarray(p1), kv_cache=jc)
        to, tc = tattn.attention(torch.from_numpy(x1), tp, tcfg, "global",
                                 torch.from_numpy(p1), kv_cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_array_equal(tc.index.numpy(), np.asarray(jc.index))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=2e-5,
                               atol=2e-5)


def test_attention_decode_past_the_cache_writes_nothing():
    """An index at the cache's end: the reference's one-hot write matches
    no position; the port's indexed write skips the sequence."""
    jcfg, tcfg = JConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(8)
    k0 = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    idx = np.asarray([4, 2], np.int32)
    jc = jattn.KVCache(jnp.asarray(k0), jnp.asarray(k0), jnp.asarray(idx))
    tc = tattn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(k0.copy()),
                       torch.from_numpy(idx))
    x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
    p1 = idx[:, None].copy()
    jo, jc = jattn.attention(jnp.asarray(x1), jp, jcfg, "global",
                             jnp.asarray(p1), kv_cache=jc)
    to, tc = tattn.attention(torch.from_numpy(x1), tp, tcfg, "global",
                             torch.from_numpy(p1), kv_cache=tc)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)


def test_attention_prefill_past_the_cache_raises():
    """The reference clamps such a write (``dynamic_update_slice``); the
    port refuses it."""
    tcfg = ModelConfig(**CFG_KW)
    _, tp = _attn_params(tcfg)
    tc = tattn.init_kv_cache(1, 8, 2, 8, torch.float32, "cpu")
    tc.index.fill_(5)
    with pytest.raises(ValueError, match="runs past"):
        tattn.attention(torch.zeros(1, 4, 32), tp, tcfg, kv_cache=tc)


def test_attention_cross():
    jcfg, tcfg = JConfig(**CFG_KW), ModelConfig(**CFG_KW)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ek = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    ev = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    jo, _ = jattn.attention(jnp.asarray(x), jp, jcfg, "global",
                            cross_kv=(jnp.asarray(ek), jnp.asarray(ev)),
                            use_pallas=True)
    to, _ = tattn.attention(torch.from_numpy(x), tp, tcfg, "global",
                            cross_kv=(torch.from_numpy(ek),
                                      torch.from_numpy(ev)), use_pallas=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5, atol=2e-5)
