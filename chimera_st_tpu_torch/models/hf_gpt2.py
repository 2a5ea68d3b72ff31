"""GPT-2 language model and its HuggingFace state-dict importer
(counterpart of chimera_st_tpu/models/hf_gpt2.py).

A faithful GPT-2: learned positions, pre-LN blocks, the fused ``c_attn``
query / key / value projection, tanh GELU (HF ``gelu_new``) and an output
head tied to ``wte``. The projections are HF ``Conv1D`` layers, whose weight
is ``[in, out]`` (the flax Dense kernel's layout), so ``import_hf_gpt2_state_dict``
renames a ``GPT2LMHeadModel.state_dict()`` without transposing anything and
without importing ``transformers``. Module names follow the flax tree
(``wte``, ``wpe``, ``h.{i}.ln_1``, ``h.{i}.c_attn``, ``h.{i}.attn_c_proj``,
``h.{i}.mlp_c_fc``, ``h.{i}.mlp_c_proj``, ``h.{i}.ln_2``, ``ln_f``).

The causal self-attention is the plain ``dot_product_attention`` (fp32
logits and softmax), as the JAX model's is a plain einsum outside any
Pallas kernel: GPT-2 launches no kernel. The JAX ``GPT2LM`` has no
incremental step, and neither has this one, so it is not a ``--lm-path``
fusion model (ROADMAP C). ``forward(tokens) -> fp32 logits [B, T, V]`` is
the surface the ``language_modeling`` task, its criteria and ``eval_lm``
drive.

The registered presets (``hf_gpt2``, ``hf_gpt2_medium``, ``hf_gpt2_large``,
``hf_gpt2_xl``) fill ``n_embd`` / ``n_layer`` / ``n_head``; the vocabulary
stays 50,257 (the task's dictionary size does not reach it, as in JAX) and
the positions 1,024, unless given. ``embed_dim``, ``layers``, ``heads`` and
``max_target_positions`` are fairseq's aliases of those fields.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention, dropout
from .embedding import Embed
from .layers import LayerNorm


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    padding_idx: int = 1  # read only by the LM criteria's masking


class Conv1D(nn.Module):
    """HF's ``Conv1D``: y = x @ weight + bias, weight ``[in, out]``."""

    def __init__(self, in_dim: int, out_dim: int, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_dim, out_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.t(), self.bias)

    def init_extra_(self, generator: torch.Generator) -> None:
        """Xavier-uniform weight, zero bias (``init_params_``'s linears)."""
        bound = math.sqrt(6.0 / sum(self.weight.shape))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()


class GPT2Block(nn.Module):
    def __init__(self, c: GPT2Config, device="cuda"):
        super().__init__()
        D = c.n_embd
        self.n_head, self.rate = c.n_head, c.dropout
        self.ln_1 = LayerNorm(D, c.layer_norm_eps, device=device)
        self.c_attn = Conv1D(D, 3 * D, device=device)
        self.attn_c_proj = Conv1D(D, D, device=device)
        self.ln_2 = LayerNorm(D, c.layer_norm_eps, device=device)
        self.mlp_c_fc = Conv1D(D, 4 * D, device=device)
        self.mlp_c_proj = Conv1D(4 * D, D, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        rate = self.rate if self.training else 0.0
        B, T, D = x.shape
        q, k, v = self.c_attn(self.ln_1(x)).split(D, dim=-1)
        shape = (B, T, self.n_head, D // self.n_head)
        attn = dot_product_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                                     causal=True)
        x = x + dropout(self.attn_c_proj(attn.reshape(B, T, D)), rate, generator)
        h = F.gelu(self.mlp_c_fc(self.ln_2(x)), approximate="tanh")
        return x + dropout(self.mlp_c_proj(h), rate, generator)


class GPT2LM(nn.Module):
    def __init__(self, cfg: GPT2Config, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        self.wte = Embed(c.vocab_size, c.n_embd, device=device)
        self.wpe = Embed(c.n_positions, c.n_embd, device=device)
        self.h = nn.ModuleList([GPT2Block(c, device=device) for _ in range(c.n_layer)])
        self.ln_f = LayerNorm(c.n_embd, c.layer_norm_eps, device=device)

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] tokens -> fp32 logits [B, T, V] (causal; the head is
        ``wte``)."""
        rate = self.cfg.dropout if self.training else 0.0
        x = self.wte(tokens) + self.wpe.weight[:tokens.shape[1]]
        x = dropout(x, rate, generator)
        for block in self.h:
            x = block(x, generator)
        return self.wte.attend(self.ln_f(x))


_HF_LAYER = {"ln_1": "ln_1", "ln_2": "ln_2", "attn.c_attn": "c_attn",
             "attn.c_proj": "attn_c_proj", "mlp.c_fc": "mlp_c_fc", "mlp.c_proj": "mlp_c_proj"}


def import_hf_gpt2_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``GPT2LMHeadModel.state_dict()`` (plain tensors or arrays under HF
    names) -> the state dict of ``GPT2LM``. ``lm_head.weight`` is ``wte``'s
    alias and the attention's ``bias`` / ``masked_bias`` buffers are causal
    masks: both are dropped. Any other key left unread raises."""

    def t(key):
        return torch.as_tensor(sd[f"transformer.{key}"]).detach().float().clone()

    out = {"wte.weight": t("wte.weight"), "wpe.weight": t("wpe.weight"),
           "ln_f.weight": t("ln_f.weight"), "ln_f.bias": t("ln_f.bias")}
    n_layer = 0
    while f"transformer.h.{n_layer}.ln_1.weight" in sd:
        n_layer += 1
    for i in range(n_layer):
        for hf, ours in _HF_LAYER.items():
            for leaf in ("weight", "bias"):
                out[f"h.{i}.{ours}.{leaf}"] = t(f"h.{i}.{hf}.{leaf}")
    read = {f"transformer.{k}" for k in ("wte.weight", "wpe.weight", "ln_f.weight",
                                         "ln_f.bias")}
    read |= {f"transformer.h.{i}.{hf}.{leaf}" for i in range(n_layer) for hf in _HF_LAYER
             for leaf in ("weight", "bias")}
    dropped = {k for k in sd if k == "lm_head.weight"
               or (k.startswith("transformer.h.") and k.endswith(("attn.bias", "attn.masked_bias")))}
    left = sorted(set(sd) - read - dropped)
    if left:
        raise ValueError(f"unread GPT-2 state-dict keys: {left[:8]}")
    return out


_ALIASES = {"embed_dim": "n_embd", "layers": "n_layer", "heads": "n_head",
            "max_target_positions": "n_positions"}


def gpt2_config(cfg_dict: Dict) -> GPT2Config:
    """The config of ``build_hf_gpt2``: the known fields, then fairseq's
    aliases where the field itself is not given (JAX ``hf_gpt2.py:166-172``)."""
    known = {f.name for f in dataclasses.fields(GPT2Config)}
    d = {k: v for k, v in cfg_dict.items() if k in known}
    for src, dst in _ALIASES.items():
        if src in cfg_dict and dst not in d:
            d[dst] = cfg_dict[src]
    return GPT2Config(**d)


def build_hf_gpt2(cfg_dict: Dict, device="cuda") -> GPT2LM:
    return GPT2LM(gpt2_config(cfg_dict), device=device)


def _preset(n_embd: int, n_layer: int, n_head: int):
    def fill(cfg: Dict) -> Dict:
        return {"n_embd": n_embd, "n_layer": n_layer, "n_head": n_head, **cfg}
    return fill


# arch name -> (model name, preset)
ARCHITECTURES = {
    "hf_gpt2": ("hf_gpt2", dict),
    "hf_gpt2_medium": ("hf_gpt2", _preset(1024, 24, 16)),
    "hf_gpt2_large": ("hf_gpt2", _preset(1280, 36, 20)),
    "hf_gpt2_xl": ("hf_gpt2", _preset(1600, 48, 25)),
}
