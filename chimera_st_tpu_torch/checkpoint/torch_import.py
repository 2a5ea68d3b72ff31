"""fairseq checkpoint importer: fairseq state dicts -> the port's state dicts
(counterpart of chimera_st_tpu/checkpoint/torch_import.py).

Loads checkpoints in the layout of the released ``Chimera_EN2XX.pt`` /
``wav2vec_small.pt``: a pickle with ``args`` (an argparse Namespace), ``model``
(the state dict) and the optimizer history.

The port's modules carry the fairseq names, so tensors keep their layout and
nearly every key its name. What the importer does:

- folds the weight-normed ``pos_conv`` (``weight_g``, ``weight_v``; torch
  ``weight_norm`` with dim=2) into a plain weight, w = g * v / ||v||_{dims (0,1)};
- drops the aliased ``decoder.output_projection.weight`` when it equals
  ``decoder.embed_tokens.weight`` (a tied decoder) and keeps it when it does
  not (a decoder built with ``share_decoder_input_output_embed=False``);
- drops the allowlisted key families (wav2vec2 pretraining-only heads,
  parameter-free sinusoidal position dummies);
- tracks which keys were read: any other key left unread is an error, so a
  tensor can never load as silently fresh-initialised.

``import_wav2vec_ctc_state_dict`` and ``import_wav2vec_seq2seq_state_dict``
read fairseq's wav2vec 2.0 fine-tune checkpoints (``Wav2VecCtc``:
``w2v_encoder.w2v_model.*`` and ``w2v_encoder.proj``; ``wav2vec_seq2seq``:
``encoder.w2v_model.*``, ``encoder.proj`` and ``decoder.*`` with the untied
``decoder.embed_out``) into the state dicts of the port's ``Wav2VecCtcModel``
/ ``Wav2VecSeq2SeqModel``; the trunk keeps its ``mask_emb`` unless
``apply_mask`` is False, which drops it (a model built without span masking
has no such parameter).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Any, Dict, Optional

import torch

# key families that have no equivalent in the graph the port builds
SKIP_PATTERNS = [
    r"\.embed_positions\._float_tensor$",  # sinusoidal dummy buffer
    r"encoder\.stashed_weights",  # joint-task swap scratch
    r"decoder\.stashed_weights",
    r"\.version$",
    r"^_ema\.",
]

# wav2vec2 pretraining-only modules (not used by extract_features)
W2V2_PRETRAIN_PATTERNS = [
    r"mask_emb$",
    r"quantizer\.",
    r"project_q\.",
    r"final_proj\.",
    r"target_glu\.",
    r"input_quantizer\.",
    r"project_inp\.",
]


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    # the ``args`` Namespace does not pass the weights-only unpickler
    return torch.load(path, map_location="cpu", weights_only=False)


def _tensor(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().float()


def _copy(sd, out, key: str, bias: bool = True):
    """A module's ``weight`` (and ``bias`` where the checkpoint has one)."""
    out[key + ".weight"] = _tensor(sd[key + ".weight"])
    if bias and key + ".bias" in sd:
        out[key + ".bias"] = _tensor(sd[key + ".bias"])


def _attn(sd, out, key: str):
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _copy(sd, out, f"{key}.{proj}")


def _enc_layer(sd, out, key: str):
    _attn(sd, out, f"{key}.self_attn")
    _copy(sd, out, f"{key}.self_attn_layer_norm")
    _copy(sd, out, f"{key}.fc1")
    _copy(sd, out, f"{key}.fc2")
    _copy(sd, out, f"{key}.final_layer_norm")


def _dec_layer(sd, out, key: str):
    _enc_layer(sd, out, key)
    _attn(sd, out, f"{key}.encoder_attn")
    _copy(sd, out, f"{key}.encoder_attn_layer_norm")


def _fold_weight_norm(sd, key: str):
    """Fold torch weight_norm(dim=2) into a plain conv weight."""
    g = _tensor(sd[key + ".weight_g"])  # [1, 1, k]
    v = _tensor(sd[key + ".weight_v"])  # [out, in/groups, k]
    norm = (v * v).sum(dim=(0, 1), keepdim=True).sqrt()
    return g * v / norm.clamp(min=1e-12), _tensor(sd[key + ".bias"])


def _count_layers(sd, pattern: str) -> int:
    rx = re.compile(pattern)
    idxs = {int(m.group(1)) for m in map(rx.match, sd) if m}
    return (max(idxs) + 1) if idxs else 0


def _import_wav2vec2(sd, out, p: str, keep_mask_emb: bool):
    """Reads the Wav2Vec2Model keys under prefix ``p`` of ``sd`` into ``out``
    under the same names: the ``default`` extractor's group norm or the
    ``layer_norm`` mode's per-layer norms (``conv_layers.{i}.2.1``), conv
    biases where the checkpoint has them, and ``mask_emb`` with
    ``keep_mask_emb``."""
    if keep_mask_emb and f"{p}mask_emb" in sd:
        out[f"{p}mask_emb"] = _tensor(sd[f"{p}mask_emb"])
    n_conv = _count_layers(sd, re.escape(p) + r"feature_extractor\.conv_layers\.(\d+)\.0\.weight")
    for i in range(n_conv):
        _copy(sd, out, f"{p}feature_extractor.conv_layers.{i}.0")
        if f"{p}feature_extractor.conv_layers.{i}.2.1.weight" in sd:
            _copy(sd, out, f"{p}feature_extractor.conv_layers.{i}.2.1")
    if f"{p}feature_extractor.conv_layers.0.2.weight" in sd:
        _copy(sd, out, f"{p}feature_extractor.conv_layers.0.2")
    _copy(sd, out, f"{p}layer_norm")
    if f"{p}post_extract_proj.weight" in sd:
        _copy(sd, out, f"{p}post_extract_proj")
    w, b = _fold_weight_norm(sd, f"{p}encoder.pos_conv.0")
    out[f"{p}encoder.pos_conv.0.weight"] = w
    out[f"{p}encoder.pos_conv.0.bias"] = b
    for i in range(_count_layers(sd, re.escape(p) + r"encoder\.layers\.(\d+)\.")):
        _enc_layer(sd, out, f"{p}encoder.layers.{i}")
    _copy(sd, out, f"{p}encoder.layer_norm")


def import_wav2vec2_state_dict(sd: Dict[str, Any], prefix: str = "",
                               keep_mask_emb: bool = False) -> Dict[str, torch.Tensor]:
    """A Wav2Vec2Model state dict (keys under ``prefix``) -> the state dict of
    the port's ``Wav2Vec2Encoder`` (keys without the prefix). Keys it does
    not read (the pretraining heads) are left to the caller:
    ``strip_w2v2_pretraining_keys`` names them."""
    out: Dict[str, torch.Tensor] = {}
    _import_wav2vec2(sd, out, prefix, keep_mask_emb)
    return {k[len(prefix):]: v for k, v in out.items()}


class _ConsumeTracking(dict):
    """Dict view that records which checkpoint keys the importer READ; the
    completeness check verifies consumption instead of trusting prefixes."""

    def __init__(self, base: Dict[str, Any]):
        super().__init__(base)
        self.consumed: set = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)


def _finish_import(sd: Dict[str, Any], out: Dict[str, torch.Tensor], handled: set):
    """Completeness check: any non-allowlisted unread key is an error."""
    unmatched = [k for k in sd if k not in handled
                 and not any(re.search(pat, k) for pat in SKIP_PATTERNS)]
    if unmatched:
        raise ValueError(f"unmatched checkpoint keys (importer out of date?): {unmatched[:20]}")
    return out


def import_interlingua_state_dict(sd: Dict[str, Any],
                                  apply_mask: bool = False) -> Dict[str, torch.Tensor]:
    """A full Chimera interlingua state dict (fairseq's
    ``s2t_transformer_w2v2_interlingua``) -> the state dict of the port's
    ``ChimeraInterlinguaModel``, to be loaded with ``strict=True``.

    By default the trunk's ``mask_emb`` is dropped like the other wav2vec2
    pretraining-only heads: fairseq's Wav2Vec2Model registers it
    unconditionally (and quantizer / project_q / final_proj when configured),
    so real fine-tune checkpoints carry them though inference never reads
    them. ``apply_mask=True`` keeps it (a model built with span masking)."""
    out: Dict[str, torch.Tensor] = {}
    tsd = _ConsumeTracking(sd)

    _import_wav2vec2(tsd, out, "encoder.wav2vec_model.", keep_mask_emb=apply_mask)
    for i in range(_count_layers(sd, r"encoder\.subsample\.conv_layers\.(\d+)\.weight")):
        _copy(tsd, out, f"encoder.subsample.conv_layers.{i}")
    for name in ("text_embed_tokens", "interlingua_embedding", "modal_embedding"):
        if f"encoder.{name}.weight" in sd:
            _copy(tsd, out, f"encoder.{name}", bias=False)
    for stack in ("transformer_layers", "audio_exclusive_layers", "interlingua_layers"):
        for i in range(_count_layers(sd, rf"encoder\.{stack}\.(\d+)\.")):
            _enc_layer(tsd, out, f"encoder.{stack}.{i}")
    if "encoder.layer_norm.weight" in sd:
        _copy(tsd, out, "encoder.layer_norm")

    _copy(tsd, out, "decoder.embed_tokens", bias=False)
    for i in range(_count_layers(sd, r"decoder\.layers\.(\d+)\.")):
        _dec_layer(tsd, out, f"decoder.layers.{i}")
    if "decoder.layer_norm.weight" in sd:
        _copy(tsd, out, "decoder.layer_norm")
    if "decoder.output_projection.weight" in sd:
        # tied: an alias of the embedding, already imported; untied: the
        # projection of a decoder built with share_decoder_input_output_embed
        # False (JAX torch_import.py:349-355)
        w_proj = _tensor(tsd["decoder.output_projection.weight"])
        w_emb = out["decoder.embed_tokens.weight"]
        if w_proj.shape != w_emb.shape or not torch.allclose(w_proj, w_emb):
            out["decoder.output_projection.weight"] = w_proj

    # documented drop: the trunk's pretraining-only heads
    handled = set(tsd.consumed)
    handled |= {k for k in sd if k.startswith("encoder.wav2vec_model.")
                and any(re.search(p, k) for p in W2V2_PRETRAIN_PATTERNS)}
    return _finish_import(sd, out, handled)


def import_wav2vec_ctc_state_dict(sd: Dict[str, Any],
                                  apply_mask: bool = True) -> Dict[str, torch.Tensor]:
    """A fairseq ``Wav2VecCtc`` fine-tune state dict (JAX
    ``torch_import.py:222-248``) -> the state dict of the port's
    ``Wav2VecCtcModel``: the trunk under ``w2v_encoder.w2v_model.`` and the
    vocabulary projection ``w2v_encoder.proj``. ``apply_mask=False`` drops
    the checkpoint's ``mask_emb``."""
    out: Dict[str, torch.Tensor] = {}
    tsd = _ConsumeTracking(sd)
    _import_wav2vec2(tsd, out, "w2v_encoder.w2v_model.", keep_mask_emb=apply_mask)
    _copy(tsd, out, "w2v_encoder.proj")
    handled = set(tsd.consumed)
    if not apply_mask:
        handled |= {k for k in sd if k.endswith(".mask_emb")}
    return _finish_import(sd, out, handled)


def import_wav2vec_seq2seq_state_dict(sd: Dict[str, Any],
                                      apply_mask: bool = True) -> Dict[str, torch.Tensor]:
    """A fairseq ``wav2vec_seq2seq`` fine-tune state dict (JAX
    ``torch_import.py:251-282``) -> the state dict of the port's
    ``Wav2VecSeq2SeqModel``: the trunk under ``encoder.w2v_model.``, the
    optional dimension bridge ``encoder.proj``, the decoder, and its untied
    output matrix ``decoder.embed_out`` as ``decoder.output_projection``."""
    out: Dict[str, torch.Tensor] = {}
    tsd = _ConsumeTracking(sd)
    _import_wav2vec2(tsd, out, "encoder.w2v_model.", keep_mask_emb=apply_mask)
    if "encoder.proj.weight" in sd:
        _copy(tsd, out, "encoder.proj")
    _copy(tsd, out, "decoder.embed_tokens", bias=False)
    for i in range(_count_layers(sd, r"decoder\.layers\.(\d+)\.")):
        _dec_layer(tsd, out, f"decoder.layers.{i}")
    if "decoder.layer_norm.weight" in sd:
        _copy(tsd, out, "decoder.layer_norm")
    if "decoder.embed_out" in sd:
        out["decoder.output_projection.weight"] = _tensor(tsd["decoder.embed_out"])
    handled = set(tsd.consumed)
    if not apply_mask:
        handled |= {k for k in sd if k.endswith(".mask_emb")}
    return _finish_import(sd, out, handled)


def strip_w2v2_pretraining_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop pretraining-only heads from a raw wav2vec2 checkpoint state dict."""
    return {k: v for k, v in sd.items()
            if not any(re.search(p, k) for p in W2V2_PRETRAIN_PATTERNS + SKIP_PATTERNS)}


def _parse_conv_feature_layers(spec: str):
    """wav2vec2's ``conv_feature_layers`` is a Python expression that fairseq
    evals: a list literal, or, in the released ``wav2vec_small.pt``,
    ``"[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512,2,2)] * 2"``. Evaluates
    literals, ``list + list`` and ``list * int`` and nothing else."""
    def ev(node):
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mult)):
            left, right = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add) and isinstance(left, list) and isinstance(right, list):
                return left + right
            if isinstance(node.op, ast.Mult) and {type(left), type(right)} == {list, int}:
                return left * right
            raise ValueError(f"unsupported conv_feature_layers expression: {spec!r}")
        return ast.literal_eval(node)

    return ev(ast.parse(spec.strip(), mode="eval").body)


def infer_interlingua_config(ckpt_args, tgt_vocab: int, src_vocab: Optional[int]):
    """An ``InterlinguaConfig`` from a checkpoint's argparse Namespace
    (``ckpt['args']`` as fairseq-train writes it)."""
    from ..models.interlingua import InterlinguaConfig

    def g(name, default):
        return getattr(ckpt_args, name, default)

    cfg = InterlinguaConfig(
        tgt_vocab_size=tgt_vocab,
        src_vocab_size=src_vocab,
        encoder_embed_dim=g("encoder_embed_dim", 512),
        encoder_ffn_dim=g("encoder_ffn_embed_dim", 2048),
        encoder_layers=g("encoder_layers", 12),
        encoder_heads=g("encoder_attention_heads", 8),
        decoder_embed_dim=g("decoder_embed_dim", 512),
        decoder_ffn_dim=g("decoder_ffn_embed_dim", 2048),
        decoder_layers=g("decoder_layers", 6),
        decoder_heads=g("decoder_attention_heads", 8),
        interlingua_length=g("interlingua_length", 16),
        interlingua_layers=g("interlingua_layers", 3),
        non_shared_encoder_layers=g("non_shared_encoder_layers", 0),
        no_interlingua=g("no_interlingua", False),
        conv_kernel_sizes=tuple(int(k) for k in str(g("conv_kernel_sizes", "5,5")).split(",")),
        conv_channels=g("conv_channels", 1024),
        dropout=g("dropout", 0.1),
        attention_dropout=g("attention_dropout", 0.1),
        activation_dropout=g("activation_dropout", 0.1),
        activation=g("activation_fn", "relu"),
        share_decoder_input_output_embed=g("share_decoder_input_output_embed", True),
        no_scale_embedding=g("no_scale_embedding", False),
    )
    # wav2vec2 trunk dims: flat on the namespace, or nested as the released
    # checkpoints carry them (ckpt["args"].w2v_args is the wav2vec2
    # checkpoint's own Namespace); a flat field wins over the nested one
    extra = {}
    for f in ("w2v2_embed_dim", "w2v2_ffn_dim", "w2v2_layers", "w2v2_heads", "w2v2_conv_pos",
              "w2v2_conv_pos_groups", "max_target_positions"):
        if hasattr(ckpt_args, f):
            extra[f] = getattr(ckpt_args, f)
    if hasattr(ckpt_args, "w2v2_conv_spec"):
        extra["w2v2_conv_spec"] = tuple(
            tuple(int(v) for v in layer) for layer in ckpt_args.w2v2_conv_spec)
    w2v = getattr(ckpt_args, "w2v_args", None)
    if w2v is not None:
        def wg(name, default):
            return getattr(w2v, name, default)

        extra.setdefault("w2v2_embed_dim", wg("encoder_embed_dim", 768))
        extra.setdefault("w2v2_ffn_dim", wg("encoder_ffn_embed_dim", 3072))
        extra.setdefault("w2v2_layers", wg("encoder_layers", 12))
        extra.setdefault("w2v2_heads", wg("encoder_attention_heads", 12))
        extra.setdefault("w2v2_conv_pos", wg("conv_pos", 128))
        extra.setdefault("w2v2_conv_pos_groups", wg("conv_pos_groups", 16))
        spec = wg("conv_feature_layers", None)
        if spec is not None:
            if isinstance(spec, str):
                spec = _parse_conv_feature_layers(spec)
            extra.setdefault("w2v2_conv_spec",
                             tuple(tuple(int(v) for v in layer) for layer in spec))
    return dataclasses.replace(cfg, **extra)
