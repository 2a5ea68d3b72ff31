"""K3: one beam step of decoder self-attention over the lazily reordered KV
cache, a hand-written CUDA kernel (csrc/decode_attention.cu) with its plain
PyTorch version beside it.

Replaces the Pallas kernel ``chimera_st_tpu/ops/pallas_decode_attention.py``
``decode_step_attention``; the oracle is the crosscol branch of the JAX
``MultiheadAttention``. The cache of one layer is ``[N, H, L, D]`` with
``N = sentences * beam`` columns; ``ancestry[l, n]`` is the column, within
the same sentence's ``beam`` columns, that holds hypothesis n's time-l
entry. Both versions write this step's K/V rows into the cache IN PLACE at
``cache_index`` and attend over ``l = 0..cache_index``; positions past
``cache_index`` are never read, so the result does not depend on L.

On the H100 the kernel is bound by its chain of dependent trips to device
memory and by the launch, not by bytes (2 us' worth) or operations. It runs
one block of four warps per (column, head), loads the ancestry entries
first and then gathers every K and V row of a time tile at once into
shared memory with 16-byte ``cp.async`` copies (two trips; a two-stage ring
for timelines longer than a tile: the most rows of a power of two within
512 chunks, 64 times in bf16 and 32 in fp32 at D 64). The warps split the
tile's rows, eight lanes a row (else the largest power of two dividing a
row's chunks: four at D 32 and D 96 in bf16 and D 80 in fp32, two at D 80
in bf16, whose tile grows to 64 times so that it holds one pass of the
warps' row groups), and merge their partial (max, sum, accumulator) at the
end. Head dims 32, 64, 80, 96 and 128 are instantiated. The time-``cache_index`` row is read
from ``k_new`` / ``v_new`` of the ancestor column and a block writes only
its own column's row, so no block reads what another writes.
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIMS = (32, 64, 80, 96, 128)


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index: int,
                           beam: int):
    """The plain PyTorch version. q, k_new, v_new: [N, H, D];
    k_cache, v_cache: [N, H, L, D] (updated in place); ancestry: [>L, N]
    int32. Returns [N, H, D]."""
    k_cache[:, :, cache_index] = k_new
    v_cache[:, :, cache_index] = v_new
    N, _, _, D = k_cache.shape
    steps = cache_index + 1
    first_col = torch.arange(N, device=q.device) // beam * beam
    src = first_col[None, :] + ancestry[:steps].long()  # [steps, N] global columns
    t = torch.arange(steps, device=q.device)[:, None]
    k_sel = k_cache[src, :, t]  # [steps, N, H, D]
    v_sel = v_cache[src, :, t]
    logits = torch.einsum("nhd,lnhd->nhl", q.float(), k_sel.float()) * D**-0.5
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("nhl,lnhd->nhd", probs.float(), v_sel.float()).to(q.dtype)


def decode_attention_cuda(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index: int,
                          beam: int):
    """Launches K3 (same contract as the plain version). All tensors
    contiguous and 16-byte aligned on one CUDA device (the C entry point
    checks the alignment and the launch raises on its error); q, k_new,
    v_new and the caches share one dtype (float32 or bfloat16); head_dim
    in HEAD_DIMS; ancestry int32."""
    if not q.is_cuda:
        raise RuntimeError("decode_attention_cuda takes CUDA tensors")
    N, H, L, D = k_cache.shape
    for t in (q, k_new, v_new):
        if t.shape != (N, H, D) or t.dtype != k_cache.dtype or not t.is_contiguous():
            raise ValueError("q, k_new and v_new must be contiguous [N, H, D] in the cache dtype")
    for t in (k_cache, v_cache):
        if t.shape != (N, H, L, D) or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("caches must be contiguous [N, H, L, D]")
    if ancestry.dtype != torch.int32 or not ancestry.is_contiguous() or ancestry.shape[1] != N:
        raise ValueError("ancestry must be contiguous int32 [rows, N]")
    if not 0 <= cache_index < min(L, ancestry.shape[0]) or N % beam or beam > 32:
        raise ValueError("decode attention kernel takes beam <= 32 dividing N, "
                         "0 <= cache_index < L")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes head_dim in {HEAD_DIMS}")
    if len({t.device for t in (q, k_new, v_new, k_cache, v_cache, ancestry)}) != 1:
        raise ValueError("all tensors must be on one device")
    out = torch.empty_like(q)
    err = _build.kernel("decode_attention")(
        _build.dtype_code(q), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), ancestry.data_ptr(), out.data_ptr(),
        N, beam, H, D, L, int(cache_index), float(D**-0.5), _build.stream_handle(q.device),
    )
    _build.check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


def decode_attention(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index: int, beam: int):
    """One beam step of cached self-attention. A CPU tensor takes the plain
    version; a CUDA tensor launches K3 (or raises)."""
    if q.is_cuda:
        return decode_attention_cuda(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index,
                                     beam)
    return decode_attention_plain(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam)


decode_attention.launches = 0
