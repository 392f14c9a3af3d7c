"""Flash attention (forward) with an online softmax.

Port of ``repro.kernels.flash_attention`` (the Pallas ``_flash_kernel``).
:func:`flash_attention` is the kernel wrapper, in the model's layout: q
``(B, T, H, dh)``, k and v ``(B, S, KV, dh)``, GQA by ``kv = h // (H/KV)``,
causal and sliding-window masks from absolute row and column indices,
ragged S masked by ``cols < S``.  On CUDA tensors it launches the
hand-written kernel (``csrc/flash_attention.cu``: one block per (b, h,
64-row q tile), 64-column K/V tiles staged in shared memory, the running
(m, l, acc) per row) or raises; on CPU tensors it runs the plain version,
:func:`flash_attention_plain`: the model's ``chunked_attention`` in
float32 over the kernel's tiles, in the kernel's order.

The reference's arithmetic is kept: q is scaled by ``dh**-0.5`` in float32
before the dot, every product and sum is float32, ``NEG_INF = -2e38`` is
finite (a fully masked tile sums garbage with weight one that the first
valid tile multiplies by ``alpha = exp(-2e38 - m) = 0``), and the output is
``acc / max(l, 1e-30)`` in q's dtype.  The causal mask is meaningful only
for T == S (the reference calls the kernel only without a cache, where that
holds); the wrapper raises on causal with T != S.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

BQ = BK = 64  # the kernel's q-tile rows and K/V-tile columns
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """The kernel's plain PyTorch version: ``chunked_attention`` in float32
    over the kernel's 64-column K/V tiles, in order, K/V padded with zeros
    to a tile multiple and the padding masked (so a row with no valid
    column averages the tile's padding as the kernel's does).  Shapes as
    :func:`flash_attention`."""
    # imported here: the models import the kernels
    from repro_torch.models.attention import chunked_attention

    B, T = q.shape[:2]
    S = k.shape[1]
    pad = (0, 0, 0, 0, 0, -S % BK)
    rows = torch.arange(T, device=q.device).expand(B, T)
    out = chunked_attention(q.float(), F.pad(k.float(), pad),
                            F.pad(v.float(), pad), rows, S, causal, window,
                            chunk=BK)
    return out.to(q.dtype)


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,T,H,dh), k/v (B,S,KV,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError("q and k/v disagree on batch or head width")
    if H % k.shape[2]:
        raise ValueError("GQA requires H % KV == 0")
    if T < 1 or k.shape[1] < 1:
        raise ValueError("empty query or key sequence")
    if causal and T != k.shape[1]:
        raise ValueError(f"causal attention needs T == S (got T={T}, "
                         f"S={k.shape[1]}): the mask compares absolute indices")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Forward attention, ``(B, T, H, dh) x (B, S, KV, dh) -> (B, T, H, dh)``
    in q's dtype: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    window = int(window)
    _check(q, k, v, causal, window)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    out = launch(q.contiguous(), k.contiguous(), v.contiguous(), causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches (CUDA path only)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> torch.Tensor:
    """Launch the kernel on inputs :func:`flash_attention` has validated
    (contiguous CUDA tensors); no host synchronisation."""
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for d_head in "
                         f"{HEAD_DIMS}, got {dh}")
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, T, S, H, KV, dh, int(bool(causal)), window,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash-attention kernel launch")
    return out
