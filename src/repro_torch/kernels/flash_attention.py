"""Flash attention (forward) with an online softmax.

Port of ``repro.kernels.flash_attention`` (the Pallas ``_flash_kernel``).
:func:`flash_attention` is the kernel wrapper, in the model's layout: q
``(B, T, H, dh)``, k and v ``(B, S, KV, dh)``, GQA by ``kv = h // (H/KV)``,
causal and sliding-window masks from absolute row and column indices,
ragged S masked by ``cols < S``.  On CUDA tensors it launches one of two
hand-written kernels, chosen by ``(dtype, dh)`` (:func:`kernel_for`), or
raises; on CPU tensors it runs the plain version of the same kernel,
:func:`flash_attention_plain`:

* ``"tensor_core"`` (``csrc/flash_attention_sm90.cu``), bf16 at
  ``dh`` 64 or 128: persistent blocks that take (b, h, 128-row q tile)
  items, 128-column K/V tiles copied by TMA, both products on the tensor
  cores (``wgmma``).  The
  logits are the unscaled bf16 dot summed in float32, then scaled; p is
  rounded to bf16 for the P V product; l sums the float32 p.  The plain
  version follows that arithmetic over the same 128-column tiles.
* ``"split_tf32"`` (``csrc/flash_attention.cu``), float32 at every
  ``dh`` of :data:`HEAD_DIMS` and bf16 at the others: 128-row q tiles,
  K/V tiles of :func:`split_tf32_cols` columns landing by ``cp.async`` in
  two stages, both products on the tensor cores (``mma.sync``) in split
  TF32 (three products per float32 product, two where K or V is bf16,
  ~2**-21 relative); its plain version is the model's
  ``chunked_attention`` in float32 over those tiles.

Both keep the reference's finite ``NEG_INF = -2e38`` (a fully masked tile
sums garbage with weight one that the first valid tile multiplies by
``alpha = exp(-2e38 - m) = 0``) and output ``acc / max(l, 1e-30)`` in q's
dtype.  The split-TF32 kernel keeps the reference's arithmetic (q scaled
by ``dh**-0.5`` in float32 before the dot, p float32) but for the split's
rounding and a fast exponential, far inside the reference's float32
tolerance of 2e-5.  The wrapper never falls back from one kernel to the
other.  The causal mask is
meaningful only for T == S (the reference calls the kernel only without a
cache, where that holds); the wrapper raises on causal with T != S.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the split-TF32 kernel's instantiations (bf16 at TC_HEAD_DIMS excepted)
HEAD_DIMS = (16, 32, 64, 80, 128, 168)
TC_BK = 128  # the tensor-core kernel's K/V-tile columns
TC_HEAD_DIMS = (64, 128)  # the tensor-core kernel's instantiations, bf16 only


def kernel_for(dtype: torch.dtype, dh: int) -> str:
    """The kernel that takes ``(dtype, dh)`` on the card: ``"tensor_core"``
    for bf16 at :data:`TC_HEAD_DIMS`, ``"split_tf32"`` for float32 or
    bf16 at the other :data:`HEAD_DIMS`; raises for anything else."""
    if dtype == torch.bfloat16 and dh in TC_HEAD_DIMS:
        return "tensor_core"
    if dtype in DTYPE_CODES and dh in HEAD_DIMS:
        return "split_tf32"
    raise ValueError(f"no flash kernel for {dtype} at d_head {dh}: the "
                     f"tensor-core kernel takes bfloat16 at d_head "
                     f"{TC_HEAD_DIMS}, the split-TF32 kernel float32 or "
                     f"bfloat16 at {HEAD_DIMS}")


def split_tf32_cols(dh: int) -> int:
    """The split-TF32 kernel's K/V-tile columns at head width ``dh``: 64,
    or 32 above 128, where two stages of 64 columns do not fit in shared
    memory beside the float32 q tile."""
    return 32 if dh > 128 else 64


def tensor_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in float32, before the output is
    rounded: over the kernel's 128-column K/V tiles in order (K/V padded
    with zeros, the padding masked), logits ``(q . k) * dh**-0.5`` from
    float32 copies of the inputs, the online softmax's (m, l) in float32,
    p rounded to bf16 for the P V product, l summed from the float32 p.
    Returns ``(B, T, H, dh)`` float32."""
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    pad = (0, 0, 0, 0, 0, -S % TC_BK)
    kf, vf = F.pad(k.float(), pad), F.pad(v.float(), pad)
    qf = q.float().reshape(B, T, KV, G, dh)
    scale = torch.tensor(dh**-0.5, dtype=torch.float32)
    rows = torch.arange(T, device=dev)[:, None]
    m = torch.full((B, T, KV, G), NEG_INF, device=dev)
    l = torch.zeros((B, T, KV, G), device=dev)
    acc = torch.zeros((B, T, KV, G, dh), device=dev)
    for c0 in range(0, kf.shape[1], TC_BK):
        cols = c0 + torch.arange(TC_BK, device=dev)[None, :]
        valid = cols < S
        if causal:
            valid = valid & (cols <= rows)
        if window > 0:
            valid = valid & (cols > rows - window)
        logits = torch.einsum("btkgd,bckd->btkgc", qf,
                              kf[:, c0:c0 + TC_BK]) * scale
        logits = logits.masked_fill(~valid[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "btkgc,bckd->btkgd", p.to(torch.bfloat16).float(),
            vf[:, c0:c0 + TC_BK])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, T, H, dh)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel that takes these inputs:
    :func:`tensor_core_plain` rounded to bf16 for bf16 at
    :data:`TC_HEAD_DIMS`; else ``chunked_attention`` in float32 over the
    split-TF32 kernel's K/V tiles (:func:`split_tf32_cols`), in order (the
    kernel's split products are its deliberate difference), K/V padded with
    zeros to a tile multiple and the padding masked (so a row with no
    valid column averages the tile's padding as the kernel's does).
    Shapes as :func:`flash_attention`."""
    # imported here: the models import the kernels
    from repro_torch.models.attention import chunked_attention

    if q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS:
        return tensor_core_plain(q, k, v, causal, window).to(q.dtype)
    B, T = q.shape[:2]
    S = k.shape[1]
    bk = split_tf32_cols(q.shape[-1])
    pad = (0, 0, 0, 0, 0, -S % bk)
    rows = torch.arange(T, device=q.device).expand(B, T)
    out = chunked_attention(q.float(), F.pad(k.float(), pad),
                            F.pad(v.float(), pad), rows, S, causal, window,
                            chunk=bk)
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
    in q's dtype: a CUDA kernel (:func:`kernel_for`) for CUDA tensors, the
    plain version for CPU tensors."""
    window = int(window)
    _check(q, k, v, causal, window)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    if dev.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {dev}")
    return launch(q.contiguous(), k.contiguous(), v.contiguous(), causal, window)


flash_attention.launches = 0  # kernel launches, both kernels (CUDA path only)
flash_attention.tensor_core_launches = 0  # of which the tensor-core kernel's


@contextlib.contextmanager
def _on_card(device):
    """Make ``device`` current; yields its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> torch.Tensor:
    """Launch the kernel :func:`kernel_for` names on inputs
    :func:`flash_attention` has validated (contiguous CUDA tensors); no
    host synchronisation.  An error of that kernel raises: no other kernel
    is tried.  Counts the launch on :func:`flash_attention` once the kernel
    is queued."""
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    kind = kernel_for(q.dtype, dh)
    lib = _build.load_library()
    out = torch.empty_like(q)
    # both kernels copy 16-byte pieces (TMA, cp.async) from aligned addresses
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    with _on_card(q.device) as stream:
        if kind == "tensor_core":
            err = lib.flash_attention_sm90_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                T, S, H, KV, dh, int(bool(causal)), window, stream)
        else:
            err = lib.flash_attention_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, T, S, H, KV, dh,
                int(bool(causal)), window, stream)
    _build.check(err, f"flash-attention kernel launch ({kind})")
    flash_attention.launches += 1
    flash_attention.tensor_core_launches += kind == "tensor_core"
    return out
