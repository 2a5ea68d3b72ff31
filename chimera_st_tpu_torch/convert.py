"""Carries weights across from the JAX package: a flax parameter tree with
numpy leaves -> a state dict of the port's model.

The inverse of chimera_st_tpu/checkpoint/torch_import.py (fairseq names ->
flax names), run in the other direction:

- Dense ``kernel [in, out]``        -> ``weight [out, in]``
- Conv ``kernel [k, in/groups, out]`` -> ``weight [out, in/groups, k]``
- LayerNorm / GroupNorm ``scale``   -> ``weight``; ``bias`` stays
- Embed ``embedding``               -> ``weight`` as it is

Every leaf of the tree must be consumed and every expected leaf present:
either way the conversion raises, as the JAX importer's completeness check
does.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


class _Consumer:
    """Flattened flax tree that records which leaves were read."""

    def __init__(self, tree: Mapping[str, Any]):
        if set(tree) == {"params"}:  # a flax variables dict
            tree = tree["params"]
        self.leaves: Dict[Path, np.ndarray] = {}
        self._flatten(tree, ())
        self.consumed = set()

    def _flatten(self, node, path: Path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                self._flatten(v, path + (str(k),))
        else:
            self.leaves[path] = np.asarray(node, dtype=np.float32)

    def take(self, path: Path) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"flax tree is missing {'/'.join(path)}")
        self.consumed.add(path)
        return self.leaves[path]

    def has(self, path: Path) -> bool:
        return any(p[: len(path)] == path for p in self.leaves)

    def count(self, path: Path, prefix: str) -> int:
        """Number of numbered children ``prefix{i}`` under ``path``."""
        rx = re.compile(re.escape(prefix) + r"(\d+)$")
        idx = {int(m.group(1)) for p in self.leaves if len(p) > len(path) and p[: len(path)] == path
               for m in [rx.match(p[len(path)])] if m}
        return max(idx) + 1 if idx else 0

    def finish(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left = sorted("/".join(p) for p in self.leaves if p not in self.consumed)
        if left:
            raise ValueError(f"unconsumed flax parameters: {left[:20]}")
        return out


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a))


def _dense(src: _Consumer, out, path: Path, key: str, bias: bool = True):
    out[f"{key}.weight"] = _t(src.take(path + ("kernel",)).T)
    if bias:
        out[f"{key}.bias"] = _t(src.take(path + ("bias",)))


def _conv(src: _Consumer, out, path: Path, key: str, bias: bool = True):
    out[f"{key}.weight"] = _t(src.take(path + ("kernel",)).transpose(2, 1, 0))
    if bias:
        out[f"{key}.bias"] = _t(src.take(path + ("bias",)))


def _norm(src: _Consumer, out, path: Path, key: str):
    out[f"{key}.weight"] = _t(src.take(path + ("scale",)))
    out[f"{key}.bias"] = _t(src.take(path + ("bias",)))


def _embed(src: _Consumer, out, path: Path, key: str):
    out[f"{key}.weight"] = _t(src.take(path + ("embedding",)))


def _attn(src, out, path: Path, key: str):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(src, out, path + (proj,), f"{key}.{proj}")


def _enc_layer(src, out, path: Path, key: str):
    _attn(src, out, path + ("self_attn",), f"{key}.self_attn")
    _norm(src, out, path + ("self_attn_layer_norm",), f"{key}.self_attn_layer_norm")
    _dense(src, out, path + ("fc1",), f"{key}.fc1")
    _dense(src, out, path + ("fc2",), f"{key}.fc2")
    _norm(src, out, path + ("final_layer_norm",), f"{key}.final_layer_norm")


def _dec_layer(src, out, path: Path, key: str):
    _enc_layer(src, out, path, key)
    _attn(src, out, path + ("encoder_attn",), f"{key}.encoder_attn")
    _norm(src, out, path + ("encoder_attn_layer_norm",), f"{key}.encoder_attn_layer_norm")


def _wav2vec2(src: _Consumer, out, path: Path, key: str):
    fe = path + ("feature_extractor",)
    for i in range(src.count(fe, "conv_")):
        conv_path = fe + (f"conv_{i}",)
        _conv(src, out, conv_path, f"{key}feature_extractor.conv_layers.{i}.0",
              bias=src.has(conv_path + ("bias",)))
    _norm(src, out, fe + ("group_norm",), f"{key}feature_extractor.conv_layers.0.2")
    _norm(src, out, path + ("layer_norm",), f"{key}layer_norm")
    if src.has(path + ("post_extract_proj",)):
        _dense(src, out, path + ("post_extract_proj",), f"{key}post_extract_proj")
    _conv(src, out, path + ("pos_conv", "conv"), f"{key}encoder.pos_conv.0")
    for i in range(src.count(path, "layers_")):
        _enc_layer(src, out, path + (f"layers_{i}",), f"{key}encoder.layers.{i}")
    _norm(src, out, path + ("encoder_layer_norm",), f"{key}encoder.layer_norm")


def _decoder(src: _Consumer, out):
    _embed(src, out, ("decoder", "embed_tokens"), "decoder.embed_tokens")
    for i in range(src.count(("decoder",), "layers_")):
        _dec_layer(src, out, ("decoder", f"layers_{i}"), f"decoder.layers.{i}")
    if src.has(("decoder", "layer_norm")):
        _norm(src, out, ("decoder", "layer_norm"), "decoder.layer_norm")


def wav2vec2_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``Wav2Vec2Encoder`` params -> state dict of the port's
    ``Wav2Vec2Encoder``."""
    src = _Consumer(tree)
    out: Dict[str, torch.Tensor] = {}
    _wav2vec2(src, out, (), "")
    return src.finish(out)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ChimeraInterlinguaModel`` params -> state dict of the port's
    ``ChimeraInterlinguaModel`` (tied decoder embeddings)."""
    src = _Consumer(tree)
    out: Dict[str, torch.Tensor] = {}
    _wav2vec2(src, out, ("wav2vec_model",), "encoder.wav2vec_model.")
    for i in range(src.count(("subsample",), "conv_layers_")):
        _conv(src, out, ("subsample", f"conv_layers_{i}"), f"encoder.subsample.conv_layers.{i}")
    for name in ("text_embed_tokens", "interlingua_embedding", "modal_embedding"):
        if src.has((name,)):
            _embed(src, out, (name,), f"encoder.{name}")
    for stack in ("transformer_layers", "audio_exclusive_layers", "interlingua_layers"):
        for i in range(src.count((), f"{stack}_")):
            _enc_layer(src, out, (f"{stack}_{i}",), f"encoder.{stack}.{i}")
    if src.has(("encoder_layer_norm",)):
        _norm(src, out, ("encoder_layer_norm",), "encoder.layer_norm")
    _decoder(src, out)
    return src.finish(out)


def s2t_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``S2TTransformerModel`` params -> state dict of the port's
    ``S2TTransformerModel`` (tied decoder embeddings)."""
    src = _Consumer(tree)
    out: Dict[str, torch.Tensor] = {}
    for i in range(src.count(("subsample",), "conv_layers_")):
        _conv(src, out, ("subsample", f"conv_layers_{i}"), f"encoder.subsample.conv_layers.{i}")
    for i in range(src.count((), "transformer_layers_")):
        _enc_layer(src, out, (f"transformer_layers_{i}",), f"encoder.transformer_layers.{i}")
    if src.has(("encoder_layer_norm",)):
        _norm(src, out, ("encoder_layer_norm",), "encoder.layer_norm")
    _decoder(src, out)
    return src.finish(out)
