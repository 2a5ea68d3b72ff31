"""K1: encoder self-attention, a hand-written CUDA kernel
(csrc/encoder_attention.cu) with its plain PyTorch version beside it.

Replaces the Pallas kernel ``chimera_st_tpu/ops/pallas_attention.py``
``fused_encoder_attention``. It serves every bidirectional self-attention
of the wav2vec2 trunk and the shared encoder. The semantics are those of
``ops/attention.py`` ``dot_product_attention``, including a fully padded
query row, which averages V over the T real keys. bf16 runs on the tensor
cores (a flash-attention forward with wgmma and TMA), fp32 on the CUDA
cores (TF32 would not hold the fp32 path to 1e-4); any other type raises.

Training: ``EncoderAttentionFn`` launches K1 forward and takes the backward
of the Pallas wrapper's ``custom_vjp`` (``pallas_attention.py:106-122``),
a plain fp32 recompute (``encoder_attention_backward``), with one change:
the logit gradient of a padded key is zeroed, as autodiff of the XLA path
gives it. That is the exact gradient of ``encoder_attention_plain``: for a
fully padded row (whose output does not depend on q or k) dq and dk are 0,
where the Pallas wrapper's backward, which leaves them unmasked, is not;
everywhere else the two agree. ``encoder_attention_applicable`` is the
Pallas wrapper's gate: with attention dropout on, the plain path with
dropout runs instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, dot_product_attention

HEAD_DIMS = (64, 80, 96, 128)


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
        raise ValueError(f"encoder attention kernel takes head_dim in {HEAD_DIMS}, T > 0; "
                         f"other head dims wait for a model that asks (ROADMAP B)")
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


def encoder_attention_applicable(q, k, causal=False, dropout_rate=0.0) -> bool:
    """Whether K1 covers an attention call (``flash_attention_applicable``,
    pallas_attention.py:128-140, whose additive bias the port's attention
    never takes): self-attention shape, not causal, and an effective
    dropout rate of 0."""
    return not causal and dropout_rate == 0.0 and q.shape[1] == k.shape[1]


def encoder_attention_backward(q, k, v, key_padding_mask, g):
    """(dq, dk, dv) of ``encoder_attention_plain`` for the output gradient
    ``g``, recomputed in fp32 and cast back to the inputs' dtype."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if key_padding_mask is not None:  # a padded key's logit is the constant -1e8
        ds = ds.masked_fill(key_padding_mask[:, None, None, :], 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class EncoderAttentionFn(torch.autograd.Function):
    """K1 forward, ``encoder_attention_backward`` backward. Under
    ``torch.autocast`` the inputs are cast to bf16 (a ctypes launch is no op
    autocast knows) and the backward runs in the forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v, key_padding_mask):
        ctx.save_for_backward(q, k, v, key_padding_mask)
        return encoder_attention_cuda(q, k, v, key_padding_mask)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v, key_padding_mask = ctx.saved_tensors
        return (*encoder_attention_backward(q, k, v, key_padding_mask, g), None)


def encoder_attention(q, k, v, key_padding_mask=None):
    """Bidirectional self-attention with a key-padding mask. A CPU tensor
    takes the plain version; a CUDA tensor launches K1 (or raises), through
    ``EncoderAttentionFn`` so that gradients flow."""
    if q.is_cuda:
        return EncoderAttentionFn.apply(q, k, v, key_padding_mask)
    return encoder_attention_plain(q, k, v, key_padding_mask)


encoder_attention.launches = 0
