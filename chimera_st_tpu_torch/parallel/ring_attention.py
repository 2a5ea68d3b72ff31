"""Ring attention: exact self-attention with the sequence axis split over
the ranks of a mesh axis (counterpart of
chimera_st_tpu/parallel/ring_attention.py).

Each rank holds a block [B, T / P, H, D] of Q, K and V. The K / V blocks
and their key masks pass once round the ring (rank i sends to i + 1) while
each rank folds the block it holds into a running softmax (fp32 max,
denominator and output accumulators), so after P ticks every query has
seen every key exactly once. A query whose keys are all padding gets zeros.

The JAX function is differentiable through ``lax.scan`` and ``ppermute``;
autograd does not pass through ``send`` / ``recv``, so ``RingAttention``
is an autograd Function whose backward runs the ring again: each tick it
adds the held block's share to dQ, and accumulates dK / dV in buffers that
travel with the K / V block, so they are home after P ticks. It is a
library function: as in JAX, no model calls it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _rotate(tensors, ranks, group, me):
    """Each tensor to the next rank of the ring, the previous rank's back."""
    P = len(ranks)
    nxt, prv = ranks[(me + 1) % P], ranks[(me - 1) % P]
    out, reqs = [], []
    for t in tensors:
        r = torch.empty_like(t)
        reqs.append(dist.isend(t.contiguous(), nxt, group=group))
        reqs.append(dist.irecv(r, prv, group=group))
        out.append(r)
    for req in reqs:
        req.wait()
    return out


def _scores(q, k, valid, scale):
    s = torch.einsum("bqhd,bkhd->bqkh", q, k) * scale
    return s.masked_fill(~valid[:, None, :, None], float("-inf"))


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, mesh, axis):
        ranks, group, me = mesh.ranks(axis), mesh.group(axis), mesh.index(axis)
        scale = q.shape[-1] ** -0.5
        qf = q.float()
        m = torch.full(q.shape[:3], float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb, valb = k.float(), v.float(), valid.to(torch.uint8)
        for tick in range(len(ranks)):
            s = _scores(qf, kb, valb.bool(), scale)
            m_new = torch.maximum(m, s.amax(dim=2))
            safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - safe[:, :, None, :])  # exp(-inf) = 0 for masked keys
            corr = torch.where(torch.isfinite(m), torch.exp(m - safe), torch.zeros_like(m))
            l = l * corr + p.sum(dim=2)
            o = o * corr[..., None] + torch.einsum("bqkh,bkhd->bqhd", p, vb)
            m = m_new
            if tick < len(ranks) - 1:
                kb, vb, valb = _rotate((kb, vb, valb), ranks, group, me)
        out = o / torch.clamp(l[..., None], min=1e-9)
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                          torch.full_like(m, float("inf")))
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.mesh, ctx.axis = mesh, axis
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, out, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        ranks, group, me = mesh.ranks(axis), mesh.group(axis), mesh.index(axis)
        scale = q.shape[-1] ** -0.5
        qf, gf = q.float(), g.float()
        delta = (gf * out).sum(-1)  # [B, Tq, H]
        dq = torch.zeros_like(qf)
        kb, vb, valb = k.float(), v.float(), valid.to(torch.uint8)
        dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
        for _ in range(len(ranks)):
            s = _scores(qf, kb, valb.bool(), scale)
            p = torch.exp(s - lse[:, :, None, :])  # 0 for masked keys and empty rows
            dv = dv + torch.einsum("bqkh,bqhd->bkhd", p, gf)
            dp = torch.einsum("bqhd,bkhd->bqkh", gf, vb)
            ds = p * (dp - delta[:, :, None, :]) * scale
            dq = dq + torch.einsum("bqkh,bkhd->bqhd", ds, kb)
            dk = dk + torch.einsum("bqkh,bqhd->bkhd", ds, qf)
            # the block and its gradient buffers move on together; after P
            # ticks they are back with the rank that owns the block
            kb, vb, valb, dk, dv = _rotate((kb, vb, valb, dk, dv), ranks, group, me)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                        padding_mask: Optional[torch.Tensor] = None,
                        axis: str = "seq") -> torch.Tensor:
    """Exact multi-head self-attention of this rank's query block [B, Tl, H,
    D] over the whole sequence, whose blocks the ``axis`` ranks hold in rank
    order; ``padding_mask`` [B, Tl] (True = pad) masks this rank's keys.
    Returns this rank's output block."""
    valid = (torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
             if padding_mask is None else ~padding_mask)
    return RingAttention.apply(q, k, v, valid, mesh, axis)
