"""K1: encoder self-attention, a hand-written CUDA kernel
(csrc/encoder_attention.cu) with its plain PyTorch version beside it.

Replaces the Pallas kernel ``chimera_st_tpu/ops/pallas_attention.py``
``fused_encoder_attention``. It serves every bidirectional self-attention
of the wav2vec2 trunk and the shared encoder. The semantics are those of
``ops/attention.py`` ``dot_product_attention``, including a fully padded
query row, which averages V over the T real keys. bf16 runs on the tensor
cores (a flash-attention forward with wgmma and TMA), fp32 on the CUDA
cores (TF32 would not hold the fp32 path to 1e-4); any other type raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import dot_product_attention

HEAD_DIMS = (64, 96)


def encoder_attention_plain(q, k, v, key_padding_mask=None):
    """The plain PyTorch version: [B, T, H, D] -> [B, T, H, D]."""
    return dot_product_attention(q, k, v, key_padding_mask=key_padding_mask)


def encoder_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launches K1. q, k, v: [B, T, H, D] contiguous CUDA tensors of one
    dtype (float32 or bfloat16), D in HEAD_DIMS; mask [B, T] bool on the
    same device. Logits are scaled by D ** -0.5."""
    if not q.is_cuda:
        raise RuntimeError("encoder_attention_cuda takes CUDA tensors")
    B, T, H, D = q.shape
    for t in (q, k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError("q, k and v must be contiguous")
    if D not in HEAD_DIMS or T == 0:
        raise ValueError(f"encoder attention kernel takes head_dim in {HEAD_DIMS}, T > 0")
    if key_padding_mask is not None:
        if (key_padding_mask.shape != (B, T) or key_padding_mask.dtype != torch.bool
                or key_padding_mask.device != q.device):
            raise ValueError("key_padding_mask must be bool [B, T] on q's device")
        key_padding_mask = key_padding_mask.contiguous()
    out = torch.empty_like(q)
    err = _build.kernel("encoder_attention")(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_padding_mask is None else key_padding_mask.data_ptr(),
        out.data_ptr(), B, T, H, D, float(D**-0.5), _build.stream_handle(q.device),
    )
    _build.check_launch("encoder_attention", err)
    encoder_attention.launches += 1
    return out


def encoder_attention(q, k, v, key_padding_mask=None):
    """Bidirectional self-attention with a key-padding mask. A CPU tensor
    takes the plain version; a CUDA tensor launches K1 (or raises)."""
    if q.is_cuda:
        return encoder_attention_cuda(q, k, v, key_padding_mask)
    return encoder_attention_plain(q, k, v, key_padding_mask)


encoder_attention.launches = 0
