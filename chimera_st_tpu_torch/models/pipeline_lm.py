"""The pipeline-parallel transformer LM with persistently stacked layers
(counterpart of chimera_st_tpu/models/pipeline_lm.py, ``transformer_lm_pipe``).

The decoder-only LM of ``transformer_lm`` whose layers' parameters live
stacked on a leading ``[L, ...]`` axis (``scan_layers.layer.*``, the JAX
``nn.scan`` tree ``scan_layers/layer/...``). The forward runs the GPipe
schedule of ``parallel/pipeline.py`` over those stacks where the model is
given a rank grid with ``pipe`` ranks (``pipeline_stages`` above 1), and
the layers in turn otherwise (no grid, or a batch that does not divide
into the chunks). Every rank keeps the whole stack; a stage reads its
slice. The layers run without dropout, as in JAX.

``stack_lm_params`` / ``unstack_lm_params`` carry a ``transformer_lm`` state
dict to this layout and back (the reference's
``convert_to_pipeline_parallel_state_dict``). The causal forward launches
no kernel; the model has no incremental step, so it is no ``--lm-path``
fusion model (ROADMAP C).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from .embedding import Embed
from .layers import LayerNorm, TransformerDecoderLayer, positional_embedding_from_mask
from .transformer_mt import TransformerLMConfig, _config


class PipelinedTransformerLM(nn.Module):
    def __init__(self, cfg: TransformerLMConfig, device="cuda", pipeline_mesh=None):
        super().__init__()
        from ..parallel.pipeline import pipeline_config

        self.cfg = c = cfg
        self.pipeline = pipeline_config(c, pipeline_mesh, check_dropout=False)
        self.embed_tokens = Embed(c.vocab_size, c.embed_dim, padding_idx=c.padding_idx,
                                  device=device)

        def layer(dev):
            return TransformerDecoderLayer(c.embed_dim, c.ffn_dim, c.heads, c.activation,
                                           c.normalize_before, cross_attention=False,
                                           causal=True, device=dev)

        # the layer the stacked parameters are applied through (not a
        # submodule: its own parameters are never used)
        self._template = [layer("meta")]
        self.scan_layers = nn.Module()
        self.scan_layers.layer = layer("meta")
        for name, p in list(self.scan_layers.layer.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = self.scan_layers.layer.get_submodule(owner) if owner else \
                self.scan_layers.layer
            init = torch.ones if leaf == "weight" and isinstance(mod, LayerNorm) else torch.zeros
            setattr(mod, leaf, nn.Parameter(init((c.layers,) + tuple(p.shape), device=device)))
        if c.normalize_before:
            self.layer_norm = LayerNorm(c.embed_dim, device=device)
        self.embed_scale = math.sqrt(c.embed_dim)

    def init_extra_(self, generator: torch.Generator) -> None:
        """``init_params_``'s scales for each layer of the stacks:
        xavier-uniform weights, zero biases, LayerNorm ones and zeros."""
        with torch.no_grad():
            for name, p in self.stacked().items():
                if name.endswith("bias"):
                    p.zero_()
                elif "layer_norm" in name:
                    p.fill_(1.0)
                else:
                    for w in p:
                        nn.init.xavier_uniform_(w, generator=generator)

    def stacked(self) -> Dict[str, torch.Tensor]:
        """{layer parameter name: its stack [L, ...]}."""
        return dict(self.scan_layers.layer.named_parameters())

    def _layer(self, params: Dict[str, torch.Tensor], h: torch.Tensor, pad_mask: torch.Tensor):
        return functional_call(self._template[0], params, (h, None, None, pad_mask), strict=True)

    def forward(self, tokens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T] tokens -> fp32 logits [B, T, V] (causal, tied output)."""
        c = self.cfg
        pad_mask = tokens == c.padding_idx
        x = self.embed_scale * self.embed_tokens(tokens)
        x = x + positional_embedding_from_mask(pad_mask, c.embed_dim, c.padding_idx).to(x.dtype)
        stacked = self.stacked()
        piped = None
        if self.pipeline is not None:
            from ..parallel.pipeline import pipelined_layer_stack

            p = self.pipeline
            piped = pipelined_layer_stack(stacked, self._layer, x, (pad_mask,), mesh=p["mesh"],
                                          stages=p["stages"], chunks=p["chunks"],
                                          remat=p["remat"])
        if piped is not None:
            x = piped
        else:
            for i in range(c.layers):
                x = self._layer({k: v[i] for k, v in stacked.items()}, x, pad_mask)
        if c.normalize_before:
            x = self.layer_norm(x)
        return self.embed_tokens.attend(x)


_LAYER_KEY = re.compile(r"^decoder\.layers\.(\d+)\.(.+)$")


def stack_lm_params(state_dict: Dict[str, torch.Tensor], num_layers: int
                    ) -> Dict[str, torch.Tensor]:
    """A ``transformer_lm`` state dict -> the ``transformer_lm_pipe`` one."""
    per: Dict[str, list] = {}
    out = {"embed_tokens.weight": state_dict["decoder.embed_tokens.weight"]}
    for key, value in state_dict.items():
        m = _LAYER_KEY.match(key)
        if m:
            per.setdefault(m.group(2), [None] * num_layers)[int(m.group(1))] = value
        elif key.startswith("decoder.layer_norm."):
            out[key[len("decoder."):]] = value
        elif key != "decoder.embed_tokens.weight":
            raise ValueError(f"{key}: not a key of a plain transformer_lm")
    for name, values in per.items():
        out[f"scan_layers.layer.{name}"] = torch.stack(values)
    return out


def unstack_lm_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_lm_params`` (a plain ``transformer_lm``'s)."""
    out = {"decoder.embed_tokens.weight": state_dict["embed_tokens.weight"]}
    for key, value in state_dict.items():
        if key.startswith("scan_layers.layer."):
            name = key[len("scan_layers.layer."):]
            for i in range(value.shape[0]):
                out[f"decoder.layers.{i}.{name}"] = value[i]
        elif key.startswith("layer_norm."):
            out[f"decoder.{key}"] = value
    return out


def build_transformer_lm_pipe(cfg_dict: Dict, device="cuda") -> PipelinedTransformerLM:
    d = dict(cfg_dict)
    d.setdefault("vocab_size", d.pop("tgt_vocab_size", 8))
    mesh = d.pop("pipeline_mesh", None)
    cfg = _config(TransformerLMConfig, d)
    if cfg.pipeline_stages > 1 and cfg.layers % cfg.pipeline_stages:
        raise ValueError("layers must divide into pipeline_stages (uniform balance)")
    return PipelinedTransformerLM(cfg, device=device, pipeline_mesh=mesh)


def transformer_lm_pipe_base(cfg: Dict) -> Dict:
    # the stacked layers run without dropout
    return {"embed_dim": 512, "ffn_dim": 2048, "layers": 6, "heads": 8, "dropout": 0.0, **cfg}


MODEL_BUILDERS = {"transformer_lm_pipe": build_transformer_lm_pipe}
ARCHITECTURES = {"transformer_lm_pipe": ("transformer_lm_pipe", transformer_lm_pipe_base)}
