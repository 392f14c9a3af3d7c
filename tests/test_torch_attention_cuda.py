"""The flash and paged attention kernels against their plain versions, on
the card.

These tests import neither jax nor the JAX package, so they run where the
card is (``python -m pytest -m cuda tests/test_torch_attention_cuda.py``);
without a card they skip.  The shapes are the reference's ``FLASH_CASES``
and ``PAGED_CASES`` (``tests/test_kernels.py``) plus ``seq_len`` 0 and 1
and a table of several 64-token steps, and the tolerances its ``_tol``:
2e-5 in float32, 2e-2 in bfloat16.  Every bf16 flash case, of either
kernel, is held besides to mean |kernel - plain| <= 5e-3 mean |plain|,
which sees a dropped K/V tile where 2e-2 cannot; the tensor-core flash
kernel (bf16 at d_head 64/128) at ragged and full-width shapes, one
launch per call.  The
split-TF32 kernel (every other width and type) is held at each of its
widths and types, at ragged T and S (100, 127, 2 047), with a window that
masks whole K/V tiles, at GQA groups 1, 2 and 8, and on unaligned views.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpaged

FLASH_CASES = [
    # (B, T, S, H, KV, dh, causal, window, dtype)
    (1, 128, 128, 4, 4, 64, True, 0, torch.float32),
    (2, 256, 256, 4, 2, 64, True, 0, torch.float32),
    (1, 128, 128, 8, 2, 128, True, 0, torch.bfloat16),
    (1, 256, 256, 4, 4, 64, True, 128, torch.float32),
    (2, 64, 192, 4, 2, 64, False, 0, torch.float32),
    (1, 100, 100, 2, 2, 64, True, 0, torch.float32),
]
F32, BF16 = torch.float32, torch.bfloat16
# the split-TF32 kernel: every width in both of its types (bf16 at 64/128
# is the tensor-core kernel's)
SPLIT_CASES = [
    (1, 100, 100, 4, 4, 16, True, 0, F32),
    (2, 127, 127, 4, 2, 32, True, 0, F32),
    (1, 2047, 2047, 8, 1, 64, True, 0, F32),
    (1, 127, 127, 8, 1, 80, True, 0, F32),
    (1, 2047, 2047, 4, 2, 80, True, 0, F32),
    (2, 100, 100, 4, 2, 128, True, 0, F32),
    (1, 2047, 2047, 2, 1, 168, True, 0, F32),
    (1, 600, 600, 4, 2, 168, True, 70, F32),  # whole tiles masked
    (1, 600, 600, 4, 4, 128, True, 70, F32),
    (2, 64, 300, 4, 2, 168, False, 0, F32),
    (1, 100, 100, 4, 1, 16, True, 0, BF16),
    (1, 127, 127, 4, 2, 32, True, 0, BF16),
    (1, 2047, 2047, 8, 1, 80, True, 0, BF16),
    (1, 600, 600, 4, 2, 168, True, 70, BF16),
    (2, 64, 300, 8, 1, 80, False, 0, BF16),
]
# the tensor-core kernel's cases: the reference's bf16 case, ragged cases
# at both head widths, and the full-width prefill shape without and with
# a 1024-token window
TC_CASES = [
    (1, 128, 128, 8, 2, 128, True, 0),
    (1, 100, 100, 2, 2, 128, True, 0),
    (1, 100, 100, 2, 2, 64, True, 0),
    (4, 2048, 2048, 16, 8, 128, True, 0),
    (4, 2048, 2048, 16, 8, 128, True, 1024),
]
MEAN_REL = 5e-3  # bf16; see test_torch_attention.py's dropped-tile tests
PAGED_CASES = [
    # (B, H, KV, dh, page, n_pages, P, dtype, seq_lens)
    (2, 4, 2, 64, 16, 4, 16, torch.float32, None),
    (3, 8, 8, 64, 32, 3, 12, torch.float32, None),
    (2, 4, 4, 128, 16, 2, 8, torch.bfloat16, None),
    (2, 4, 2, 64, 16, 4, 16, torch.float32, [0, 37]),
    (2, 4, 4, 128, 16, 2, 8, torch.bfloat16, [1, 1]),
    # 4, 3 and (seq_len 0) 4 steps of 64 tokens: the double-buffered step
    # buffers are reused from the third step on
    (3, 4, 2, 64, 16, 16, 64, torch.float32, [256, 131, 0]),
]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return "cuda"


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + SPLIT_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, case):
    B, T, S, H, KV, dh, causal, window, dtype = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, T, H, dh), dtype, cuda_device)
    k = _randn(rng, (B, S, KV, dh), dtype, cuda_device)
    v = _randn(rng, (B, S, KV, dh), dtype, cuda_device)
    before = tflash.flash_attention.launches
    tc0 = tflash.flash_attention.tensor_core_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert tflash.flash_attention.launches == before + 1
    tc = tflash.kernel_for(dtype, dh) == "tensor_core"
    assert tflash.flash_attention.tensor_core_launches == tc0 + tc
    want = tflash.flash_attention_plain(q, k, v, causal, window)
    a, b = got.float().cpu(), want.float().cpu()
    np.testing.assert_allclose(a.numpy(), b.numpy(), **_tol(dtype))
    if dtype == torch.bfloat16:
        assert float((a - b).abs().mean()) <= MEAN_REL * float(b.abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [(F32, 80), (F32, 168), (BF16, 80)])
def test_flash_split_tf32_kernel_on_unaligned_views(cuda_device, dtype, dh):
    """q, k and v that start one element into their storage: the wrapper
    copies them to aligned tensors for the kernel's 16-byte copies."""
    B, T, H, KV = 1, 127, 4, 2
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (1 + B * T * n * dh,), dtype, cuda_device)[1:]
               .view(B, T, n, dh) for n in (H, KV, KV))
    assert q.data_ptr() % 16
    got = ops.flash_attention(q, k, v, causal=True)
    want = tflash.flash_attention_plain(q, k, v, True, 0)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_tensor_core_kernel_matches_plain_on_card(cuda_device, case):
    B, T, S, H, KV, dh, causal, window = case
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, T, H, dh), torch.bfloat16, cuda_device)
    k = _randn(rng, (B, S, KV, dh), torch.bfloat16, cuda_device)
    v = _randn(rng, (B, S, KV, dh), torch.bfloat16, cuda_device)
    n0 = tflash.flash_attention.launches
    tc0 = tflash.flash_attention.tensor_core_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert tflash.flash_attention.launches == n0 + 1
    assert tflash.flash_attention.tensor_core_launches == tc0 + 1
    want = tflash.flash_attention_plain(q, k, v, causal, window)
    a, b = got.float().cpu(), want.float().cpu()
    np.testing.assert_allclose(a.numpy(), b.numpy(), **_tol(torch.bfloat16))
    assert float((a - b).abs().mean()) <= MEAN_REL * float(b.abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_on_card(cuda_device, case):
    B, H, KV, dh, page, n, P, dtype, seq_lens = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, H, dh), dtype, cuda_device)
    pk = _randn(rng, (P, page, KV, dh), dtype, cuda_device)
    pv = _randn(rng, (P, page, KV, dh), dtype, cuda_device)
    bt = torch.from_numpy(rng.permutation(P)[: B * n].reshape(B, n).astype(
        np.int32)).to(cuda_device)
    if seq_lens is None:
        seq_lens = rng.integers(1, n * page + 1, B)
    sl = torch.tensor(np.asarray(seq_lens), dtype=torch.int32,
                      device=cuda_device)
    before = tpaged.paged_attention.launches
    got = ops.paged_attention(q, pk, pv, bt, sl)
    assert tpaged.paged_attention.launches == before + 1
    want = tpaged.paged_attention_plain(q, pk, pv, bt, sl)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))
