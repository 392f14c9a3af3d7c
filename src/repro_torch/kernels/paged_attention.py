"""Paged decode attention: one query token per sequence over a paged KV pool.

Port of ``repro.kernels.paged_attention`` (the Pallas ``_paged_kernel``).
The serving layer keeps K/V in fixed-size pages; a sequence's pages are
scattered and named by its row of the block table.  :func:`paged_attention`
is the kernel wrapper: on CUDA tensors it launches the hand-written kernel
(``csrc/paged_attention.cu``: one block per (b, kv head) that reads its
block-table row from device memory and walks the pages in order with an
online softmax, the ``H/KV`` query heads of the KV head sharing each loaded
page) or raises; on CPU tensors it runs the plain version,
:func:`paged_attention_plain`, which follows ``ref.paged_attention_ref``:
gather the pages into dense K/V, then a masked softmax.

As in the reference: head ``h = kv * group + j``; positions
``>= seq_lens[b]`` are masked with the finite ``NEG_INF``; a block table is
padded with page 0, whose positions are masked by value; ``seq_len == 0``
masks every position and gives the uniform mean of V over the table's
pages, not NaN.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -2.0e38
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the kernel's instantiations: one thread per column
MAX_GROUP = 8  # query heads per KV head the kernel holds in registers
MAX_PAGE = 64  # tokens per page: the kernel stages up to 64 tokens a step


def paged_attention_plain(q: torch.Tensor, pages_k: torch.Tensor,
                          pages_v: torch.Tensor, block_table: torch.Tensor,
                          seq_lens: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version (``ref.paged_attention_ref``):
    shapes as :func:`paged_attention`."""
    B, H, dh = q.shape
    _, page, KV, _ = pages_k.shape
    n = block_table.shape[1]
    idx = block_table.long()
    k = pages_k[idx].reshape(B, n * page, KV, dh)
    v = pages_v[idx].reshape(B, n * page, KV, dh)
    group = H // KV
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * dh**-0.5
    valid = (torch.arange(n * page, device=q.device)[None, :]
             < seq_lens.long()[:, None])
    logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v.float()).to(q.dtype)


def _check(q, pages_k, pages_v, block_table, seq_lens):
    if q.dim() != 3 or pages_k.dim() != 4 or pages_k.shape != pages_v.shape:
        raise ValueError(f"want q (B,H,dh), pages (P,page,KV,dh); got "
                         f"{tuple(q.shape)}, {tuple(pages_k.shape)}, "
                         f"{tuple(pages_v.shape)}")
    B, H, dh = q.shape
    P, page, KV, pdh = pages_k.shape
    if pdh != dh or H % KV:
        raise ValueError("q and the pages disagree on head width, or "
                         "H % KV != 0")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or block_table.shape[1] < 1 or block_table.dtype != torch.int32:
        raise ValueError("block_table must be (B, n_pages >= 1) int32")
    if seq_lens.shape != (B,) or seq_lens.dtype != torch.int32:
        raise ValueError("seq_lens must be (B,) int32")
    if not (q.dtype == pages_k.dtype == pages_v.dtype) \
            or q.dtype not in DTYPE_CODES:
        raise ValueError("q and the pages must share float32 or bfloat16")
    if len({t.device for t in (q, pages_k, pages_v, block_table,
                               seq_lens)}) != 1:
        raise ValueError("all inputs must be on one device")
    if block_table.numel() and (int(block_table.min()) < 0
                                or int(block_table.max()) >= P):
        raise ValueError(f"block_table holds a page id outside [0, {P})")


def paged_attention(q: torch.Tensor, pages_k: torch.Tensor,
                    pages_v: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over paged KV: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    q: ``(B, H, dh)``; pages_k/v: ``(P, page, KV, dh)``; block_table:
    ``(B, n_pages)`` int32 page ids (pad with 0); seq_lens: ``(B,)`` int32
    valid token counts.  Returns ``(B, H, dh)`` in q's dtype.  Raises on a
    page id outside the pool (one host synchronisation per call).
    """
    _check(q, pages_k, pages_v, block_table, seq_lens)
    dev = q.device
    if dev.type == "cpu":
        return paged_attention_plain(q, pages_k, pages_v, block_table, seq_lens)
    if dev.type != "cuda":
        raise ValueError(f"no paged-attention kernel for device {dev}")
    out = launch(q.contiguous(), pages_k.contiguous(), pages_v.contiguous(),
                 block_table.contiguous(), seq_lens.contiguous())
    paged_attention.launches += 1
    return out


paged_attention.launches = 0  # kernel launches (CUDA path only)


def launch(q: torch.Tensor, pages_k: torch.Tensor, pages_v: torch.Tensor,
           block_table: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on inputs :func:`paged_attention` has validated
    (contiguous CUDA tensors, page ids inside the pool); no host
    synchronisation."""
    B, H, dh = q.shape
    _, page, KV, _ = pages_k.shape
    group = H // KV
    if dh not in HEAD_DIMS or group > MAX_GROUP or page > MAX_PAGE:
        raise ValueError(f"the paged kernel is built for d_head in {HEAD_DIMS}, "
                         f"at most {MAX_GROUP} query heads per KV head and "
                         f"pages of at most {MAX_PAGE} tokens; got d_head {dh}, "
                         f"{group} heads, pages of {page}")
    if pages_k.data_ptr() % 16 or pages_v.data_ptr() % 16:
        raise ValueError("the pages must be 16-byte aligned (16-byte copies)")
    lib = _build.load_library()
    n_pages = block_table.shape[1]
    if lib.paged_attention_shared_bytes(q.element_size(), dh, group,
                                        n_pages) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"a block table of {n_pages} pages does not fit in "
                         "shared memory")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), pages_k.data_ptr(),
            pages_v.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), B, H, KV, dh, page, n_pages,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "paged-attention kernel launch")
    return out
