"""Weight quantization: scalar fake-quant with a straight-through gradient,
quant-noise block dropout and iterative product quantization (counterpart
of chimera_st_tpu/ops/quantization.py).

Pure functions over tensors and state dicts, as the JAX package's are over
parameter trees:

- ``fake_quant``: quantize-dequantize, ``scale * (clip(round(x / scale +
  zero), 0, 2**bits - 1) - zero)``; its gradient passes ``x``'s through
  unchanged (``FakeQuant``, the JAX ``custom_vjp``). Each division is
  rounded once from fp64, so the card's result is bit-equal to the CPU's
  and to the JAX package's;
- ``int8_params``: the per-tensor (scale, zero point) of a min/max
  observation that always spans 0;
- ``quantize_params_scalar``: ``fake_quant`` of every tensor of a state dict
  with two or more dimensions and at least ``min_size`` elements;
- ``quant_noise``: drops blocks of ``block_size`` input rows of a weight,
  each with probability ``p``, and rescales every element by ``1 / (1 -
  p)``. The port's weights are ``[out, in]`` (the JAX kernel's ``[in, out]``
  transposed), so a block runs along the last axis and a mask is ``[out,
  ceil(in / block_size)]``; the remainder rows form a partial block, and the
  rescale is unbiased for them too (JAX ``tests/test_misc_fixes.py:59``);
- ``pq_quantize`` / ``pq_dequantize`` / ``quantize_params_pq``: k-means over
  the blocks of ``block_size`` consecutive elements of the flattened weight
  (Lloyd iterations on the weight's device, distances in chunks of blocks).
  The initial centroids and the re-seeding of an empty cluster draw from
  ``numpy.random.default_rng(seed)`` in the JAX package's order, so both
  packages start from the same centroids.

A ``torch.Generator`` (on the weight's device) keys ``quant_noise``'s mask.
The JAX package calls these functions only from its tests, so no CLI flag
reaches them.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b rounded once to a's dtype: the quotient in fp64 (exact to
    2p + 2 bits, so its rounding is the correctly rounded fp32 quotient),
    so that every device gives the IEEE quotient the JAX package's XLA
    division gives."""
    return (a.double() / (b.double() if torch.is_tensor(b) else float(b))).to(a.dtype)


class FakeQuant(torch.autograd.Function):
    """Quantize-dequantize whose backward is the identity on ``x`` (the
    straight-through estimator) and nothing for ``scale`` / ``zero``."""

    @staticmethod
    def forward(ctx, x, scale, zero, bits: int):
        q = torch.clamp(torch.round(_div(x, scale) + zero), 0, 2 ** bits - 1)
        return scale * (q - zero)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               bits: int = 8) -> torch.Tensor:
    return FakeQuant.apply(x, scale, zero, bits)


def int8_params(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor (scale, zero point) of a min/max observation of ``x``."""
    mn = torch.clamp(x.min(), max=0.0)
    mx = torch.clamp(x.max(), min=0.0)
    scale = torch.clamp(_div(mx - mn, 2 ** bits - 1), min=1e-8)
    return scale, torch.round(_div(-mn, scale))


def _quantized(x, min_size: int) -> bool:
    return torch.is_tensor(x) and x.is_floating_point() and x.ndim >= 2 \
        and x.numel() >= min_size


def quantize_params_scalar(state_dict: Mapping[str, torch.Tensor], bits: int = 8,
                           min_size: int = 256) -> Dict[str, torch.Tensor]:
    """Post-training fake quantization of every weight matrix of a state
    dict; biases, norms and other small tensors stay as they are."""
    out = {}
    for name, x in state_dict.items():
        if _quantized(x, min_size):
            scale, zero = int8_params(x, bits)
            x = fake_quant(x, scale, zero, bits)
        out[name] = x
    return out


def quant_noise(x: torch.Tensor, p: float, block_size: int = 8,
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block dropout of a ``[out, in]`` weight: each block of ``block_size``
    input rows is zeroed with probability ``p`` (``mask`` ``[out, nb]``, True
    = dropped, or drawn from ``generator``), then every element is divided
    by ``1 - p``."""
    if p <= 0:
        return x
    out_dim, in_dim = x.shape[-2], x.shape[-1]
    nb = -(-in_dim // block_size)
    if mask is None:
        mask = torch.rand((out_dim, nb), generator=generator, device=x.device) < p
    mask = mask.to(x.device).repeat_interleave(block_size, dim=-1)[..., :in_dim]
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x) / (1.0 - p)


class PQWeight(NamedTuple):
    centroids: torch.Tensor  # [n_centroids, block_size]
    assignments: torch.Tensor  # [n_blocks] int32
    shape: Tuple[int, ...]  # the weight's shape


# the bytes of one chunk of the block-to-centroid distance buffer: 2 GB on
# the card, 256 MB on the CPU; the argmin is taken per block, so the chunk
# changes no result
_CARD_CHUNK_BYTES = 1 << 31
_HOST_CHUNK_BYTES = 1 << 28


def _nearest(blocks: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Index of the nearest centroid of each block, by the summed squared
    difference (as the JAX package computes it), in chunks of blocks."""
    budget = _CARD_CHUNK_BYTES if blocks.is_cuda else _HOST_CHUNK_BYTES
    chunk = max(1, budget // (centroids.numel() * 4))
    out = torch.empty(blocks.shape[0], dtype=torch.int64, device=blocks.device)
    for s in range(0, blocks.shape[0], chunk):
        d = ((blocks[s:s + chunk, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        out[s:s + chunk] = d.argmin(1)
    return out


def pq_quantize(weight: torch.Tensor, block_size: int = 8, n_centroids: int = 256,
                n_iter: int = 15, seed: int = 0) -> PQWeight:
    """k-means product quantization of one weight, on its device."""
    w = weight.detach().float()
    flat = w.reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block_size)
    n = blocks.shape[0]
    rng = np.random.default_rng(seed)
    n_c = min(n_centroids, n)
    centroids = blocks[torch.from_numpy(rng.choice(n, n_c, replace=False)).to(w.device)].clone()
    for _ in range(n_iter):
        assign = _nearest(blocks, centroids)
        sums = torch.zeros_like(centroids).index_add_(0, assign, blocks)
        counts = torch.bincount(assign, minlength=n_c)
        means = sums / counts.clamp(min=1)[:, None].to(sums.dtype)
        centroids = torch.where((counts > 0)[:, None], means, centroids)
        for c in torch.nonzero(counts == 0).flatten().tolist():
            # a dead centroid re-seeds from a random block, in the order of
            # the JAX package's loop over the centroids
            centroids[c] = blocks[int(rng.integers(n))]
    assign = _nearest(blocks, centroids).to(torch.int32)
    return PQWeight(centroids, assign, tuple(w.shape))


def pq_dequantize(pq: PQWeight) -> torch.Tensor:
    """The dense weight from centroids and assignments; a gradient reaches
    the centroids through the gather."""
    flat = pq.centroids[pq.assignments.long()].reshape(-1)
    size = int(np.prod(pq.shape))
    return flat[:size].reshape(pq.shape)


def quantize_params_pq(state_dict: Mapping[str, torch.Tensor], block_size: int = 8,
                       n_centroids: int = 256, min_size: int = 4096
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, PQWeight]]:
    """PQ of every weight of a state dict with two or more dimensions and at
    least ``min_size`` elements -> (the state dict with those weights
    dequantized, {name: PQWeight})."""
    out, codebooks = {}, {}
    for name, x in state_dict.items():
        if _quantized(x, min_size):
            codebooks[name] = pq = pq_quantize(x, block_size, n_centroids)
            x = pq_dequantize(pq).to(x.dtype)
        out[name] = x
    return out, codebooks
