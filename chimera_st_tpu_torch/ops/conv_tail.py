"""K2: the wav2vec2 conv-extractor tail (layers 1-6), a hand-written CUDA
kernel (csrc/conv_tail.cu) with its plain PyTorch version beside it.

Replaces the Pallas kernel ``chimera_st_tpu/ops/pallas_conv.py``
``fused_conv_tail``. Each layer is a stride-2 VALID conv, 512 -> 512
channels, no bias, followed by exact GELU; the kernel runs one layer per
launch (see the source for why the six layers are not fused on Hopper).
bf16 runs on the tensor cores (wgmma fed by TMA), fp32 on the CUDA cores.
Activations are channels-last [B, T, C]; weights are in torch's Conv1d
layout [C_out, C_in, k].

Training: ``ConvTailFn`` launches K2 forward and, as the Pallas wrapper's
``custom_vjp`` (``pallas_conv.py:183-205``), differentiates the plain
version in the backward: it saves only the tail's input and weights and
recomputes the six layers there, so no layer's activations are kept.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build

# (kernel, stride) of the tail: the wav2vec2-base extractor's layers 1-6
TAIL_SPEC = ((3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2))
CH = 512


def conv_tail_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version: [B, T1, C] -> [B, T6, C]."""
    y = x.transpose(1, 2)
    for w in weights:
        y = F.gelu(F.conv1d(y, w, stride=2))
    return y.transpose(1, 2).contiguous()


def conv_tail_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Launches K2 once per layer. x: [B, T1, CH] contiguous CUDA tensor,
    float32 or bfloat16; weights: [CH, CH, k] of the same dtype and device."""
    if not x.is_cuda:
        raise RuntimeError("conv_tail_cuda takes CUDA tensors")
    if x.dim() != 3 or x.shape[2] != CH or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, {CH}] tensor")
    fn = _build.kernel("conv_tail")
    code = _build.dtype_code(x)
    stream = _build.stream_handle(x.device)
    for w in weights:
        if w.dtype != x.dtype or w.device != x.device or w.shape[:2] != (CH, CH):
            raise ValueError(f"weights must be [{CH}, {CH}, k] in x's dtype and device")
        k = w.shape[2]
        B, t_in, _ = x.shape
        t_out = (t_in - k) // 2 + 1
        if t_out <= 0:
            raise ValueError(f"input of {t_in} frames is too short for the conv tail")
        # bf16: [C_out, k, C_in] (K-major for wgmma); fp32: [k, C_in, C_out]
        w_kernel = (w.permute(0, 2, 1) if code == _build.DTYPE_CODES[torch.bfloat16]
                    else w.permute(2, 1, 0)).contiguous()
        out = torch.empty((B, t_out, CH), dtype=x.dtype, device=x.device)
        err = fn(code, x.data_ptr(), w_kernel.data_ptr(), out.data_ptr(), B, t_in, t_out, CH, k,
                 stream)
        _build.check_launch("conv_tail", err)
        conv_tail.launches += 1
        x = out
    return x


def conv_tail_backward(x: torch.Tensor, weights: Sequence[torch.Tensor], g: torch.Tensor):
    """(dx, dw_1, ..., dw_6) of ``conv_tail_plain`` for the output gradient
    ``g``: the plain tail recomputed from its input, then differentiated.
    Weights are used in x's dtype; their gradients come back in theirs."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        ws = [w.detach().requires_grad_() for w in weights]
        y = conv_tail_plain(x, [w.to(x.dtype) for w in ws])
        return torch.autograd.grad(y, [x, *ws], g)


class ConvTailFn(torch.autograd.Function):
    """K2 forward, ``conv_tail_backward`` backward. Under ``torch.autocast``
    x and the weights are cast to bf16; otherwise the (fp32) weights are
    cast to x's dtype here, as the kernel takes one dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, *weights):
        ctx.save_for_backward(x, *weights)
        return conv_tail_cuda(x, [w.to(x.dtype) for w in weights])

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        return conv_tail_backward(x, weights, g)


def conv_tail(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Conv layers 1-6 of the wav2vec2 extractor. A CPU tensor takes the
    plain version; a CUDA tensor launches K2 (or raises), through
    ``ConvTailFn`` so that gradients flow."""
    if x.is_cuda:
        return ConvTailFn.apply(x, *weights)
    return conv_tail_plain(x, weights)


conv_tail.launches = 0
