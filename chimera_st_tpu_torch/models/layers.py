"""Core transformer building blocks (counterpart of
chimera_st_tpu/models/layers.py), batch-major [B, T, C].

Parameter names follow the fairseq state dict (q_proj/k_proj/..., fc1/fc2,
self_attn_layer_norm, ...), so ``convert.py`` is a name map. Linear and
conv layers are built without drawing random numbers (zero weights): their
values come from a checkpoint, ``convert.params_from_flax`` or
``init_params_`` with an explicit ``torch.Generator``. Norms keep fp32
parameters and statistics whatever the compute dtype
(``cast_compute_dtype_``, inference only; training keeps fp32 parameters
and computes in bf16 under ``torch.autocast``).

Dropout sits where the JAX layers put it (``layers.py:569-599``,
``:610-641``, ``:695-765``): after each attention block, on the attention
probabilities, after the activation and after ``fc2``. It acts only in
training mode, and its masks come from the ``generator`` each forward
takes (``dropout``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import NEG_INF, dot_product_attention, dropout
from ..ops.decode_attention import decode_attention
from ..ops.encoder_attention import encoder_attention, encoder_attention_applicable
from .embedding import Embed


def _zeroed(module: nn.Module, device) -> nn.Module:
    module = module.to_empty(device=device)
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


def linear(in_dim: int, out_dim: int, bias: bool = True, *, device) -> nn.Linear:
    """nn.Linear with zero parameters (built on the meta device, so no
    random initialisation runs)."""
    return _zeroed(nn.Linear(in_dim, out_dim, bias=bias, device="meta"), device)


def conv1d(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
           groups: int = 1, bias: bool = True, *, device) -> nn.Conv1d:
    """nn.Conv1d with zero parameters (see ``linear``)."""
    conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride, padding=padding, groups=groups,
                     bias=bias, device="meta")
    return _zeroed(conv, device)


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1, *, device) -> nn.Conv2d:
    """nn.Conv2d with zero parameters (see ``linear``); callers pad
    explicitly."""
    return _zeroed(nn.Conv2d(in_ch, out_ch, kernel, stride=stride, device="meta"), device)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and parameters, output in the input
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def get_activation(name: str) -> Callable:
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu  # exact erf GELU, as the reference
    raise ValueError(f"unknown activation {name!r}")


def sinusoidal_positions(num_embeddings: int, dim: int, padding_idx: int = 1,
                         device=None) -> torch.Tensor:
    """fairseq-layout sinusoid table [num_embeddings + padding_idx + 1, dim]:
    [sin | cos] halves, row ``padding_idx`` zero; timestep t has position id
    ``padding_idx + 1 + t``."""
    half = dim // 2
    n = num_embeddings + padding_idx + 1
    freq = torch.exp(
        torch.arange(half, dtype=torch.float32, device=device) * -(math.log(10000.0) / (half - 1))
    )
    angles = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freq[None, :]
    table = torch.cat([torch.sin(angles), torch.cos(angles)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, torch.zeros(n, 1, device=device)], dim=1)
    table[padding_idx] = 0.0
    return table


def positional_embedding_from_mask(padding_mask: torch.Tensor, dim: int,
                                   padding_idx: int = 1) -> torch.Tensor:
    """[B, T, dim] positions for padded sequences: non-pad timestep t gets id
    ``padding_idx + 1 + t`` (counting only non-pad steps), pads get the zero
    row ``padding_idx``."""
    T = padding_mask.shape[1]
    table = sinusoidal_positions(T, dim, padding_idx, device=padding_mask.device)
    nonpad = (~padding_mask).long()
    pos = torch.cumsum(nonpad, dim=1) * nonpad + padding_idx
    return table[pos]


def position_at_step(table: torch.Tensor, step: int, padding_idx: int = 1) -> torch.Tensor:
    """Row of a ``sinusoidal_positions`` table for decode step ``step``; a
    step past the table takes its last row, as the JAX gather clamps an
    out-of-range index."""
    return table[min(padding_idx + 1 + step, table.shape[0] - 1)]


def cast_compute_dtype_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Casts the parameters of linear, conv and embedding layers to the
    compute dtype, in place; norms keep fp32 parameters, as in the JAX
    package (param_dtype fp32, compute dtype bf16)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, Embed)):
            m.to(dtype)
    return module


class MultiheadAttention(nn.Module):
    """Multi-head attention: full sequence (self or ``kv=`` cross), with
    attention dropout in training; grouped beam cross-attention over
    un-repeated encoder K/V and the cached lazy-reorder beam step (both
    inference only). Under tensor parallelism (``parallel/partition.py``)
    a rank holds ``num_heads`` of the heads: its projections' slices."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        self.q_proj = linear(embed_dim, embed_dim, device=device)
        self.k_proj = linear(embed_dim, embed_dim, device=device)
        self.v_proj = linear(embed_dim, embed_dim, device=device)
        self.out_proj = linear(embed_dim, embed_dim, device=device)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.num_heads, self.head_dim)

    def compute_kv(self, kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keys and values projected once: [B, S, H, D] each."""
        return self._split(self.k_proj(kv)), self._split(self.v_proj(kv))

    def forward(self, query: torch.Tensor, kv: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [B, Tq, C], kv [B, Tk, C] (None: self-attention)."""
        q = self._split(self.q_proj(query))
        src = query if kv is None else kv
        k, v = self.compute_kv(src)
        rate = self.dropout if self.training else 0.0
        if kv is None and encoder_attention_applicable(q, k, causal=causal, dropout_rate=rate):
            # bidirectional self-attention without dropout: the encoder stacks (K1)
            out = encoder_attention(q, k, v, key_padding_mask)
        else:
            out = dot_product_attention(q, k, v, key_padding_mask=key_padding_mask,
                                        causal=causal, dropout_rate=rate, generator=generator)
        return self.out_proj(out.reshape(*query.shape[:2], self.num_heads * self.head_dim))

    def grouped_cross(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor], groups: int,
                      dropout_rate: float = 0.0,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Beam cross-attention: query [B*groups, 1, C] against the
        UN-repeated encoder k/v [B, S, H, D] that the beams of one sentence
        share; ``dropout_rate`` > 0 drops the attention probabilities."""
        N = query.shape[0]
        B = N // groups
        q = self._split(self.q_proj(query)).reshape(B, groups, self.num_heads, self.head_dim)
        logits = torch.einsum("bkhd,bshd->bhks", q.float(), k.float()) * self.head_dim**-0.5
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        probs = dropout(torch.softmax(logits, dim=-1).to(query.dtype), dropout_rate, generator)
        out = torch.einsum("bhks,bshd->bkhd", probs.float(), v.float()).to(query.dtype)
        return self.out_proj(out.reshape(N, 1, self.num_heads * self.head_dim))

    def cached_step(self, query: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    ancestry: torch.Tensor, cache_index: int, groups: int,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step of self-attention, query [N, 1, C], over the
        lazily reordered cache [N, H, L, D] (updated in place at
        ``cache_index``): K3, or ``int8_cached_attention`` over an int8 cache
        with its scales."""
        N = query.shape[0]
        q = self._split(self.q_proj(query))[:, 0]  # [N, H, D]
        k_new = self._split(self.k_proj(query))[:, 0]
        v_new = self._split(self.v_proj(query))[:, 0]
        if k_scale is not None:
            out = int8_cached_attention(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
                                        ancestry, cache_index, groups)
        else:
            out = decode_attention(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index,
                                   groups)
        return self.out_proj(out.reshape(N, 1, self.num_heads * self.head_dim))

    def attention_weights(self, query: torch.Tensor, kv: torch.Tensor,
                          key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Head-averaged attention probabilities [B, Tq, Tk] (for
        ``--print-alignment``)."""
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(kv))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.head_dim**-0.5
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        return torch.softmax(logits, dim=-1).mean(dim=1)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row: x [N, H, D] -> (int8 [N, H, D], fp32 scale
    [N]), the scale amax / 127 over each row's H x D values, rounded half to
    even (``torch.round``, as ``jnp.round``)."""
    r = x.float()
    s = torch.clamp(r.abs().amax(dim=(1, 2)), min=1e-8) / 127.0
    return torch.round(r / s[:, None, None]).to(torch.int8), s


def int8_cached_attention(q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, ancestry,
                          cache_index: int, beam: int) -> torch.Tensor:
    """One beam step of self-attention over an int8 KV cache, the
    ``--kv-cache-int8`` path: plain PyTorch (the JAX package runs it in XLA,
    never in Pallas), the contract of ``decode_attention_plain`` with int8
    caches [N, H, L, D] and their fp32 scales [N, L]. This step's K/V rows
    are quantised into the caches in place; the dequantisation is folded in
    as JAX folds it: each logit times its key row's scale, each probability
    times its value row's scale (before the cast to the compute dtype)."""
    k_q, k_s = quantize_rows(k_new)
    v_q, v_s = quantize_rows(v_new)
    k_cache[:, :, cache_index], v_cache[:, :, cache_index] = k_q, v_q
    k_scale[:, cache_index], v_scale[:, cache_index] = k_s, v_s
    N, _, _, D = k_cache.shape
    steps = cache_index + 1
    first_col = torch.arange(N, device=q.device) // beam * beam
    src = first_col[None, :] + ancestry[:steps].long()  # [steps, N] global columns
    t = torch.arange(steps, device=q.device)[:, None]
    dtype = q.dtype
    k_sel = k_cache[src, :, t].to(dtype)  # [steps, N, H, D]
    v_sel = v_cache[src, :, t].to(dtype)
    logits = torch.einsum("nhd,lnhd->nhl", q.float(), k_sel.float()) * D**-0.5
    logits = logits * k_scale[src, t].t()[:, None, :]
    probs = torch.softmax(logits, dim=-1) * v_scale[src, t].t()[:, None, :]
    return torch.einsum("nhl,lnhd->nhd", probs.to(dtype).float(), v_sel.float()).to(dtype)


class _Sublayers(nn.Module):
    """Residual sublayers shared by the encoder and decoder layers (which own
    fc1/fc2 and the norms under the fairseq names, and set the rates
    ``dropout`` and ``activation_dropout``)."""

    normalize_before: bool
    dropout: float
    activation_dropout: float

    def _drop(self, x: torch.Tensor, p: float, generator) -> torch.Tensor:
        return dropout(x, p if self.training else 0.0, generator)

    def _sublayer(self, x: torch.Tensor, norm: LayerNorm, fn: Callable,
                  generator=None) -> torch.Tensor:
        residual = x
        if self.normalize_before:
            x = norm(x)
        x = residual + self._drop(fn(x), self.dropout, generator)
        if not self.normalize_before:
            x = norm(x)
        return x

    def _ffn_sublayer(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        def ffn(h):
            return self.fc2(self._drop(self.act(self.fc1(h)), self.activation_dropout, generator))

        return self._sublayer(x, self.final_layer_norm, ffn, generator)


class TransformerEncoderLayer(_Sublayers):
    """Pre/post-LN encoder layer, with the interlingua ``cross_only`` form."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int, activation: str = "relu",
                 normalize_before: bool = True, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 device="cuda"):
        super().__init__()
        self.normalize_before = normalize_before
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attention_dropout,
                                            device=device)
        self.self_attn_layer_norm = LayerNorm(embed_dim, device=device)
        self.fc1 = linear(embed_dim, ffn_dim, device=device)
        self.fc2 = linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = LayerNorm(embed_dim, device=device)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, encoder_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._sublayer(x, self.self_attn_layer_norm, lambda h: self.self_attn(
            h, key_padding_mask=encoder_padding_mask, generator=generator), generator)
        return self._ffn_sublayer(x, generator)

    def cross_only(self, queries: torch.Tensor, keys: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Interlingua layer: the memory slots [B, M, C] attend to the encoder
        states [B, T, C] with this layer's self-attention parameters (the
        reference's masked self-attention over [h; mem], restricted to the M
        memory rows it keeps)."""
        if self.normalize_before:
            keys = self.self_attn_layer_norm(keys)
        x = self._sublayer(queries, self.self_attn_layer_norm, lambda h: self.self_attn(
            h, kv=keys, key_padding_mask=key_padding_mask, generator=generator), generator)
        return self._ffn_sublayer(x, generator)


class TransformerDecoderLayer(_Sublayers):
    """Pre/post-LN decoder layer: teacher-forced ``forward`` and the
    lazy-reorder beam ``step``. With ``cross_attention=False`` (the
    decoder-only language model) it has no ``encoder_attn`` and no
    ``encoder_attn_layer_norm``, as a flax tree of that model has none: flax
    creates them only when they are called, and a call without encoder input
    skips them (JAX ``layers.py:729``). With ``causal=False`` (the
    non-autoregressive models' decoder, JAX ``layers.py:651-657``) the
    self-attention is bidirectional over the canvas with its pad keys
    masked, which K1 serves where it applies; such a layer has no ``step``."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int, activation: str = "relu",
                 normalize_before: bool = True, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 cross_attention: bool = True, causal: bool = True, device="cuda"):
        super().__init__()
        self.causal = causal
        self.normalize_before = normalize_before
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.self_attn = MultiheadAttention(embed_dim, num_heads, attention_dropout,
                                            device=device)
        self.self_attn_layer_norm = LayerNorm(embed_dim, device=device)
        if cross_attention:
            self.encoder_attn = MultiheadAttention(embed_dim, num_heads, attention_dropout,
                                                   device=device)
            self.encoder_attn_layer_norm = LayerNorm(embed_dim, device=device)
        self.fc1 = linear(embed_dim, ffn_dim, device=device)
        self.fc2 = linear(ffn_dim, embed_dim, device=device)
        self.final_layer_norm = LayerNorm(embed_dim, device=device)
        self.act = get_activation(activation)

    def forward(self, x: torch.Tensor, encoder_out: Optional[torch.Tensor],
                encoder_padding_mask: Optional[torch.Tensor] = None,
                self_attn_padding_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``encoder_out`` None: no cross-attention (the language model)."""
        x = self._sublayer(x, self.self_attn_layer_norm, lambda h: self.self_attn(
            h, key_padding_mask=self_attn_padding_mask, causal=self.causal, generator=generator),
            generator)
        if encoder_out is not None:
            x = self._sublayer(x, self.encoder_attn_layer_norm, lambda h: self.encoder_attn(
                h, kv=encoder_out, key_padding_mask=encoder_padding_mask, generator=generator),
                generator)
        return self._ffn_sublayer(x, generator)

    def step(self, x: torch.Tensor, encoder_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
             encoder_padding_mask: Optional[torch.Tensor], cache: Tuple[torch.Tensor, ...],
             ancestry: torch.Tensor, cache_index: int, groups: int,
             generator: Optional[torch.Generator] = None,
             cross_attention_dropout: bool = False) -> torch.Tensor:
        """x [B*groups, 1, C] -> [B*groups, 1, C]; the cache updated in
        place. In training mode (``--retain-dropout``) the residual and
        activation dropouts act, as in the JAX cached step. The cached
        self-attention never drops its probabilities; the cross-attention
        drops them only with ``cross_attention_dropout``: the JAX step does
        where the encoder K/V batch equals the query batch (beam 1, and
        sampling's repeated layout), and not in its grouped beam branch.
        ``encoder_kv`` None: no cross-attention (the language model)."""
        x = self._sublayer(x, self.self_attn_layer_norm, lambda h: self.self_attn.cached_step(
            h, *cache[:2], ancestry, cache_index, groups, *cache[2:]), generator)
        if encoder_kv is None:
            return self._ffn_sublayer(x, generator)
        rate = self.encoder_attn.dropout if self.training and cross_attention_dropout else 0.0
        x = self._sublayer(x, self.encoder_attn_layer_norm, lambda h: self.encoder_attn.
                           grouped_cross(h, *encoder_kv, encoder_padding_mask, groups, rate,
                                         generator), generator)
        return self._ffn_sublayer(x, generator)

    def encoder_attn_weights(self, x: torch.Tensor, encoder_out: torch.Tensor,
                             encoder_padding_mask: Optional[torch.Tensor],
                             self_attn_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Head-averaged cross-attention probabilities [B, T, S] of this
        layer for its input x [B, T, C] (no dropout)."""
        residual = x
        if self.normalize_before:
            x = self.self_attn_layer_norm(x)
        x = residual + self.self_attn(x, key_padding_mask=self_attn_padding_mask,
                                      causal=self.causal)
        if not self.normalize_before:
            x = self.self_attn_layer_norm(x)
        q = self.encoder_attn_layer_norm(x) if self.normalize_before else x
        return self.encoder_attn.attention_weights(q, encoder_out, encoder_padding_mask)
