"""Plain PyTorch pieces of the references, in fp32, or in the control's
lower precision.

Nothing here imports the program. ``Precision("fp32")`` computes every
product in fp32 (run it under ``fp32_exact()``, which turns TF32 off);
``Precision("fp8")`` is the control: both operands of every matrix product
and convolution are rounded to float8 e4m3 with one scale a tensor (its
absolute maximum at 448), forward only (the gradient passes the rounding
straight through).

Dropout draws its keep-mask as the program documents its one dropout
(``ops/attention.py``): ``empty(shape, bool).bernoulli_(1 - p, generator)``,
then keeps ``x / (1 - p)``; given the same generator state and the same
sites in the same order, the masks are the program's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e8  # the value a masked attention logit is set to


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matrix products and convolutions while open."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale for the tensor, back in x's
    dtype; the gradient passes straight through."""
    amax = x.detach().abs().amax()
    if not bool(amax > 0):
        return x
    scale = amax / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.name == "fp8" else x

    def linear(self, x, w, b=None):
        y = torch.matmul(self.q(x), self.q(w).t())
        return y if b is None else y + b

    def conv1d(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv1d(self.q(x), self.q(w), b, stride=stride, padding=padding, groups=groups)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


Dropout = Callable[[torch.Tensor, float], torch.Tensor]


def no_dropout(x: torch.Tensor, p: float) -> torch.Tensor:
    return x


def seeded_dropout(generator: torch.Generator) -> Dropout:
    """Inverted dropout whose masks come from ``generator``."""

    def drop(x: torch.Tensor, p: float) -> torch.Tensor:
        if p == 0.0:
            return x
        keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
            1.0 - p, generator=generator)
        return torch.where(keep, x / (1.0 - p), 0.0)

    return drop


def layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def channel_norm(x, w, b, eps=1e-5):
    """GroupNorm with one group a channel over [B, C, T]: every channel
    normalised over the whole (padded) time axis."""
    mean = x.mean(dim=2, keepdim=True)
    var = (x - mean).square().mean(dim=2, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w[:, None] + b[:, None]


def sinusoids(n: int, dim: int, padding_idx: int = 1, device=None) -> torch.Tensor:
    """fairseq's sinusoid table [n + padding_idx + 1, dim]: [sin | cos],
    the padding row zero."""
    half = dim // 2
    rows = n + padding_idx + 1
    freq = torch.exp(torch.arange(half, dtype=torch.float64, device=device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = torch.arange(rows, dtype=torch.float64, device=device)[:, None] * freq[None, :]
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float()
    table[padding_idx] = 0.0
    return table


def positions(pad_mask: torch.Tensor, dim: int, padding_idx: int = 1) -> torch.Tensor:
    """[B, T, dim]: the t-th real position takes row padding_idx + 1 + t, a
    pad the zero row."""
    table = sinusoids(pad_mask.shape[1], dim, padding_idx, pad_mask.device)
    real = (~pad_mask).long()
    return table[torch.cumsum(real, dim=1) * real + padding_idx]


def embed(table: torch.Tensor, ids: torch.Tensor, padding_idx: Optional[int]) -> torch.Tensor:
    out = table[ids]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def attention(prec: Precision, q, k, v, key_pad=None, causal=False, p=0.0,
              drop: Dropout = no_dropout):
    """q [B, Tq, H, D], k / v [B, Tk, H, D] -> [B, Tq, H, D]; masked
    logits set to NEG_INF; dropout on the probabilities."""
    logits = prec.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        tq, tk = logits.shape[-2:]
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, NEG_INF)
    if key_pad is not None:
        logits = logits.masked_fill(key_pad[:, None, None, :], NEG_INF)
    probs = drop(torch.softmax(logits, dim=-1), p)
    return prec.einsum("bhqk,bkhd->bqhd", probs, v)


class Block:
    """Reads one transformer layer's weights under ``prefix`` (fairseq
    names) and computes its parts."""

    def __init__(self, W, prefix: str, heads: int, prec: Precision):
        self.W, self.p, self.heads, self.prec = W, prefix, heads, prec

    def w(self, name):
        return self.W[f"{self.p}.{name}"]

    def lin(self, name, x):
        return self.prec.linear(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"))

    def ln(self, name, x):
        return layer_norm(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"))

    def mha(self, attn: str, x, kv=None, key_pad=None, causal=False, p=0.0,
            drop: Dropout = no_dropout):
        src = x if kv is None else kv
        split = lambda t: t.reshape(*t.shape[:2], self.heads, -1)
        q = split(self.lin(f"{attn}.q_proj", x))
        k = split(self.lin(f"{attn}.k_proj", src))
        v = split(self.lin(f"{attn}.v_proj", src))
        out = attention(self.prec, q, k, v, key_pad, causal, p, drop)
        return self.lin(f"{attn}.out_proj", out.reshape(*x.shape[:2], -1))

    def ffn(self, x, act, p_act, drop: Dropout):
        return self.lin("fc2", drop(act(self.lin("fc1", x)), p_act))
