"""Carries weights and optimizer state across between the JAX package's
trees (flax parameter trees, optax Adam state, numpy leaves) and the port's
state dicts (fairseq names).

One table, ``_RULES``, names each module on both sides: a module of the
port's state dict (``encoder.transformer_layers.3.fc1``) and its flax path
(``transformer_layers_3/fc1``), with the kind that says how its leaves map:

- ``dense``  ``weight [out, in]``          <-> ``kernel [in, out]`` (``dense_nobias``:
  without ``bias``, the untied ``output_projection``)
- ``conv``   ``weight [out, in/groups, k]`` <-> ``kernel [k, in/groups, out]``
- ``norm``   ``weight``                     <-> ``scale``
- ``embed``  ``weight``                     <-> ``embedding``

``bias`` keeps its name and layout. ``params_from_flax`` and
``params_to_flax`` read the same table in the two directions, so they
cannot drift apart. The tables are ``interlingua``, ``s2t``, ``wav2vec2``,
``transformer`` (the MT ``TransformerModel``), ``transformer_lm`` (its
adaptive softmax included), ``transformer_lm_char`` (with the character
embedder: ``symbols`` is its ``symbol_embeddings`` leaf) and one for each
non-autoregressive model (the ``transformer`` table under ``backbone/``
plus its heads; ``crf`` is the NAT-CRF's ``E1`` / ``E2``), ``bart`` (the
same under ``backbone/`` and the classification head) and
``multilingual_transformer`` (``enc_<lang>/`` and ``dec_<lang>/`` groups,
``{g}`` in a template matching the group: a language or ``shared``), and the
wav2vec family's ``wav2vec_ctc``, ``wav2vec_seq2seq``, ``wav2vec2_pretrain``
and ``wav2vec`` (v1; a module's own parameters, ``mask_emb`` and the
quantizers' tables, are kinds of their own), ``masked_lm`` (RoBERTa /
BERT / XLM, its ``lm_head_bias`` a kind of its own), and the convolutional
and recurrent zoo's ``fconv``, ``fconv_lm``, ``fconv_self_att``,
``lightconv``, ``lightconv_lm``, ``lstm``, ``lstm_lm``, ``rnn_classifier``,
``dummy_model`` and ``s2t_berard`` (``dense_opt_bias`` a recurrent cell's
gate layers, ``conv2d`` flax's NHWC kernels ``[kh, kw, in, out]``,
``param_weight`` a lightweight convolution's own ``[H, K]`` weight);
``model_kind`` names the one of a port model. Every leaf must match a rule and every module must have
all of its kind's leaves, or the conversion raises, as the JAX importer's
completeness check does.

``optimizer_state_to_optax`` / ``optimizer_state_from_optax`` map an
optimizer's state to the tree a JAX ``.ckpt`` of that ``--optimizer``
holds, and back, through ``OPTAX_CHAINS``, a table keyed by the chain's
layout. For ``adam`` the chain state is ``{"0": {"count", "mu": {"params":
…}, "nu": {"params": …}}, "1": {"count"}}`` (``scale_by_adam``, then the
schedule's own count), with an empty ``{}`` for each state without fields:
a decoupled weight decay (``adamw``: ``"1"`` is ``{}`` and the schedule
moves to ``"2"``), the L2 decay that ``--weight-decay`` puts before
adagrad, adadelta, sgd, nag and adamax (``{"0": {}, "1": …}``), the
global-norm clip that ``--clip-norm`` puts first in a chain (``{"0": {},
"1": …}``), and, under a ``--fix-*`` mask, ``optax.multi_transform``'s
``{"inner_states": {"train": {"inner_state": …}, "freeze": {"inner_state": {}}}}``
where each frozen leaf of a state's trees is ``{}``. Adafactor's ``v_row``
/ ``v_col`` / ``v`` hold a ``(1,)`` placeholder where a parameter is not
factored (or is) and are kept in the flax layout (``checkpoint_axes``). These
layouts were read from the trees the JAX trainer writes.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]

# kind -> ((torch leaf, flax leaf, required), ...)
_LEAVES = {
    "dense": (("weight", "kernel", True), ("bias", "bias", True)),
    "dense_nobias": (("weight", "kernel", True),),
    "conv": (("weight", "kernel", True), ("bias", "bias", True)),
    "conv_opt_bias": (("weight", "kernel", True), ("bias", "bias", False)),
    "dense_opt_bias": (("weight", "kernel", True), ("bias", "bias", False)),
    # flax's NHWC ``nn.Conv``: ``kernel [kh, kw, in, out]`` <-> ``weight [out, in, kh, kw]``
    "conv2d": (("weight", "kernel", True), ("bias", "bias", True)),
    # a module's own ``weight`` in one layout on both sides (LightweightConv's [H, K])
    "param_weight": (("weight", "weight", True),),
    "norm": (("weight", "scale", True), ("bias", "bias", True)),
    "embed": (("weight", "embedding", True),),
    "symbols": (("symbol_embeddings", "symbol_embeddings", True),),
    "crf": (("E1", "E1", True), ("E2", "E2", True)),
    # a module's own parameters: the trunk's span-masking embedding, the
    # Gumbel quantizer's codebook or the k-means quantizer's embedding
    "mask_emb": (("mask_emb", "mask_emb", True),),
    "quantizer": (("codebook", "codebook", False), ("embedding", "embedding", False)),
    # the masked LM's output bias, a parameter of the model itself
    "lm_head_bias": (("lm_head_bias", "lm_head_bias", True),),
    # HF's Conv1D: ``weight [in, out]``, the kernel's own layout
    "hf_conv1d": (("weight", "kernel", True), ("bias", "bias", True)),
    # the stacked LM's layers: ``weight [L, out, in]`` <-> ``kernel [L, in, out]``
    "stacked_dense": (("weight", "kernel", True), ("bias", "bias", True)),
}


def _torch_axes(kind: str, leaf: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The permutation of a flax leaf's axes that gives the torch layout
    (None: the same layout)."""
    if leaf == "kernel" and kind.startswith("dense"):
        return tuple(reversed(range(ndim)))
    if leaf == "kernel" and kind == "conv2d":
        return (3, 2, 0, 1)
    if leaf == "kernel" and kind == "stacked_dense":
        return (0, 2, 1)
    if leaf == "kernel" and kind == "hf_conv1d":
        return None
    if leaf == "kernel":  # conv [k, in/g, out] -> [out, in/g, k]
        return (2, 1, 0)
    return None


def _flax_axes(kind: str, leaf: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The permutation of a torch leaf's axes that gives the flax layout."""
    if leaf == "weight" and kind.startswith("dense"):
        return tuple(reversed(range(ndim)))
    if leaf == "weight" and kind == "conv2d":
        return (2, 3, 1, 0)
    if leaf == "weight" and kind == "stacked_dense":
        return (0, 2, 1)
    if leaf == "weight" and kind.startswith("conv"):
        return (2, 1, 0)
    return None


def _enc_layer(t: str, f: str) -> List[Tuple[str, str, str]]:
    rules = [(f"{t}.self_attn.{p}", f"{f}/self_attn/{p}", "dense")
             for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
    rules += [(f"{t}.self_attn_layer_norm", f"{f}/self_attn_layer_norm", "norm"),
              (f"{t}.fc1", f"{f}/fc1", "dense"), (f"{t}.fc2", f"{f}/fc2", "dense"),
              (f"{t}.final_layer_norm", f"{f}/final_layer_norm", "norm")]
    return rules


def _dec_layer(t: str, f: str) -> List[Tuple[str, str, str]]:
    return _enc_layer(t, f) + [
        (f"{t}.encoder_attn.{p}", f"{f}/encoder_attn/{p}", "dense")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj")
    ] + [(f"{t}.encoder_attn_layer_norm", f"{f}/encoder_attn_layer_norm", "norm")]


def _wav2vec2(t: str, f: str) -> List[Tuple[str, str, str]]:
    """The trunk under torch prefix ``t`` / flax prefix ``f`` (``t`` ends
    with a dot, ``f`` with a slash, both empty for a trunk alone); the
    ``layer_norm`` extractor's norms and ``mask_emb`` where it has them."""
    return [
        (f"{t}feature_extractor.conv_layers.{{i}}.0", f"{f}feature_extractor/conv_{{i}}",
         "conv_opt_bias"),
        (f"{t}feature_extractor.conv_layers.0.2", f"{f}feature_extractor/group_norm", "norm"),
        (f"{t}feature_extractor.conv_layers.{{i}}.2.1", f"{f}feature_extractor/ln_{{i}}", "norm"),
        (t.rstrip("."), f.rstrip("/"), "mask_emb"),
        (f"{t}layer_norm", f"{f}layer_norm", "norm"),
        (f"{t}post_extract_proj", f"{f}post_extract_proj", "dense"),
        (f"{t}encoder.pos_conv.0", f"{f}pos_conv/conv", "conv"),
        *_enc_layer(f"{t}encoder.layers.{{i}}", f"{f}layers_{{i}}"),
        (f"{t}encoder.layer_norm", f"{f}encoder_layer_norm", "norm"),
    ]


def _decoder(cross_attention: bool = True) -> List[Tuple[str, str, str]]:
    layer = _dec_layer if cross_attention else _enc_layer
    return [("decoder.embed_tokens", "decoder/embed_tokens", "embed"),
            *layer("decoder.layers.{i}", "decoder/layers_{i}"),
            ("decoder.layer_norm", "decoder/layer_norm", "norm")]


# an untied decoder's output projection (share_decoder_input_output_embed
# False; JAX transformer_decoder.py:139-152)
_OUTPUT_PROJECTION = ("decoder.output_projection", "decoder/output_projection", "dense_nobias")
# the Transformer family's decoder options (JAX transformer_decoder.py:104-117;
# flax names the decoder's embedding LayerNorm after its attribute)
_DECODER_OPTIONS = [
    ("decoder.embed_positions", "decoder/embed_positions", "embed"),
    ("decoder.layernorm_embedding", "decoder/layernorm_embedding_mod", "norm"),
    _OUTPUT_PROJECTION,
]


def _encoder_stacks(*stacks: str) -> List[Tuple[str, str, str]]:
    out = []
    for s in stacks:
        out += _enc_layer(f"encoder.{s}.{{i}}", f"{s}_{{i}}")
    return out


_SUBSAMPLE = [("encoder.subsample.conv_layers.{i}", "subsample/conv_layers_{i}", "conv")]

# the language model's adaptive softmax (JAX models/adaptive_softmax.py)
_ADAPTIVE_SOFTMAX = [
    ("adaptive_softmax.head", "adaptive_softmax/head", "dense_nobias"),
    ("adaptive_softmax.tail_proj.{i}", "adaptive_softmax/tail_{i}_proj", "dense_nobias"),
    ("adaptive_softmax.tail_out.{i}", "adaptive_softmax/tail_{i}_out", "dense_nobias"),
]

# the character embedder in place of the decoder's embedding table (JAX
# models/character_embedder.py; its convolutions are named by width)
_CHARACTER_EMBEDDER = [
    ("decoder.embed_tokens", "decoder/embed_tokens", "symbols"),
    ("decoder.embed_tokens.char_embeddings", "decoder/embed_tokens/char_embeddings", "embed"),
    ("decoder.embed_tokens.convs.conv_w{i}", "decoder/embed_tokens/conv_w{i}", "conv"),
    ("decoder.embed_tokens.highway.layers.{i}", "decoder/embed_tokens/highway/layer_{i}",
     "dense"),
    ("decoder.embed_tokens.projection", "decoder/embed_tokens/projection", "dense"),
]

# model -> (torch module template, flax module template, kind); ``{i}`` is a
# layer index
_RULES = {
    "interlingua": [
        *_wav2vec2("encoder.wav2vec_model.", "wav2vec_model/"),
        *_SUBSAMPLE,
        *[(f"encoder.{n}", n, "embed")
          for n in ("text_embed_tokens", "interlingua_embedding", "modal_embedding")],
        *_encoder_stacks("transformer_layers", "audio_exclusive_layers", "interlingua_layers"),
        ("encoder.layer_norm", "encoder_layer_norm", "norm"),
        *_decoder(), _OUTPUT_PROJECTION,
    ],
    "s2t": [*_SUBSAMPLE, *_encoder_stacks("transformer_layers"),
            ("encoder.layer_norm", "encoder_layer_norm", "norm"), *_decoder(),
            _OUTPUT_PROJECTION],
    "wav2vec2": _wav2vec2("", ""),
    "transformer": [
        ("encoder.embed_tokens", "embed_tokens", "embed"),
        ("encoder.embed_positions", "embed_positions", "embed"),
        ("encoder.layernorm_embedding", "layernorm_embedding", "norm"),
        *_enc_layer("encoder.layers.{i}", "layers_{i}"),
        ("encoder.layer_norm", "encoder_layer_norm", "norm"),
        *_decoder(), *_DECODER_OPTIONS,
    ],
    "transformer_lm": [*_decoder(cross_attention=False), *_DECODER_OPTIONS,
                       *_ADAPTIVE_SOFTMAX],
    "transformer_lm_char": [*_CHARACTER_EMBEDDER, *_decoder(cross_attention=False)[1:],
                            *_DECODER_OPTIONS, *_ADAPTIVE_SOFTMAX],
}

# the non-autoregressive models: the ``transformer`` table under
# ``backbone``, and each model's heads
_BACKBONE = [(f"backbone.{t}", f"backbone/{f}", kind) for t, f, kind in _RULES["transformer"]]
_LENGTH_HEAD = [("length_head", "length_head", "dense")]
_RULES.update({
    "cmlm_transformer": [*_BACKBONE, *_LENGTH_HEAD],
    "nonautoregressive_transformer": [*_BACKBONE, *_LENGTH_HEAD],
    "iterative_nonautoregressive_transformer": [*_BACKBONE, *_LENGTH_HEAD],
    "nacrf_transformer": [*_BACKBONE, *_LENGTH_HEAD, ("crf", "crf", "crf")],
    "levenshtein_transformer": [*_BACKBONE, ("mask_ins_head", "mask_ins_head", "dense"),
                                ("word_del_head", "word_del_head", "dense")],
    "insertion_transformer": [*_BACKBONE, ("slot_proj", "slot_proj", "dense")],
})


# GPT-2 (JAX models/hf_gpt2.py) and the stacked pipeline LM (JAX
# models/pipeline_lm.py: ``scan_layers/layer/`` holds each leaf of the
# causal layer stacked on a leading [L] axis)
_RULES["hf_gpt2"] = [
    ("wte", "wte", "embed"), ("wpe", "wpe", "embed"), ("ln_f", "ln_f", "norm"),
    *[(f"h.{{i}}.{n}", f"h_{{i}}/{n}", "norm") for n in ("ln_1", "ln_2")],
    *[(f"h.{{i}}.{n}", f"h_{{i}}/{n}", "hf_conv1d")
      for n in ("c_attn", "attn_c_proj", "mlp_c_fc", "mlp_c_proj")],
]
_RULES["transformer_lm_pipe"] = [
    ("embed_tokens", "embed_tokens", "embed"), ("layer_norm", "layer_norm", "norm"),
    *[(f"scan_layers.layer.self_attn.{n}", f"scan_layers/layer/self_attn/{n}", "stacked_dense")
      for n in ("q_proj", "k_proj", "v_proj", "out_proj")],
    *[(f"scan_layers.layer.{n}", f"scan_layers/layer/{n}", "stacked_dense")
      for n in ("fc1", "fc2")],
    *[(f"scan_layers.layer.{n}", f"scan_layers/layer/{n}", "norm")
      for n in ("self_attn_layer_norm", "final_layer_norm")],
]

# BART: the ``transformer`` table under ``backbone/`` and the sentence
# classification head; the multilingual transformer: an encoder a source
# language group (``{g}``: a language or ``shared``), the ``transformer``
# table's encoder rows, and a decoder a target language group
_RULES["bart"] = [*_BACKBONE, ("classification_dense", "classification_dense", "dense"),
                  ("classification_out", "classification_out", "dense")]
_RULES["multilingual_transformer"] = [
    *[(t.replace("encoder.", "encoders.{g}.", 1), f"enc_{{g}}/{f}", kind)
      for t, f, kind in _RULES["transformer"] if t.startswith("encoder.")],
    *[(t.replace("decoder.", "decoders.{g}.", 1), f.replace("decoder/", "dec_{g}/", 1), kind)
      for t, f, kind in _RULES["transformer"] if t.startswith("decoder.")],
]

# the wav2vec 2.0 family: the CTC and seq2seq fine-tune models (the trunk
# under ``trunk/w2v_model/``, as the JAX ``_W2VTrunk`` names it), the
# pre-training model (its own ``mask_emb`` beside the trunk, either
# quantizer) and wav2vec v1
_RULES["wav2vec_ctc"] = [*_wav2vec2("w2v_encoder.w2v_model.", "trunk/w2v_model/"),
                         ("w2v_encoder.proj", "proj", "dense")]
_RULES["wav2vec_seq2seq"] = [*_wav2vec2("encoder.w2v_model.", "trunk/w2v_model/"),
                             ("encoder.proj", "proj", "dense"), *_decoder(),
                             ("decoder.output_projection", "decoder/output_projection",
                              "dense_nobias")]
_RULES["wav2vec2_pretrain"] = [
    *_wav2vec2("wav2vec_model.", "wav2vec_model/"),
    ("", "", "mask_emb"),
    ("quantizer", "quantizer", "quantizer"),
    ("quantizer.weight_proj", "quantizer/weight_proj", "dense"),
    ("quantizer.proj", "quantizer/proj", "conv_opt_bias"),
    ("quantizer.group_norm", "quantizer/group_norm", "norm"),
    ("project_q", "project_q", "dense"),
    ("final_proj", "final_proj", "dense"),
]
_RULES["wav2vec"] = [("feature_convs.{i}", "feat_conv_{i}", "conv"),
                     ("feature_norms.{i}", "feat_norm_{i}", "norm"),
                     ("agg_convs.{i}", "agg_conv_{i}", "conv"),
                     ("step_predictors.{i}", "pred_{i}", "dense_nobias")]

# the masked-LM family (RoBERTa / BERT / XLM): the encoder stack, the LM head
# with its bias and, for the bert* presets, the next-sentence head
_RULES["masked_lm"] = [("embed_tokens", "embed_tokens", "embed"),
                       ("emb_layer_norm", "emb_layer_norm", "norm"),
                       *_enc_layer("layers.{i}", "layers_{i}"),
                       ("lm_head_dense", "lm_head_dense", "dense"),
                       ("lm_head_layer_norm", "lm_head_layer_norm", "norm"),
                       ("", "", "lm_head_bias"),
                       ("sentence_projection", "sentence_projection", "dense")]

# the convolutional and recurrent zoo. A flax recurrent cell's dense layers
# (``ii`` / ``if`` ... without bias, ``hi`` ... with; a GRU's ``hr`` / ``hz``
# without) map one to one onto the port's ``cell`` of ``models/lstm.py``,
# whose forward stacks them for ``torch.lstm`` / ``torch.gru``


def _rnn(t: str, f: str) -> List[Tuple[str, str, str]]:
    return [(f"{t}.cell.{{g}}", f"{f}/cell/{{g}}", "dense_opt_bias")]


def _dense(*names: str) -> List[Tuple[str, str, str]]:
    return [(n, n, "dense") for n in names]


def _per_layer(t: str, f: str, kind: str = "dense") -> Tuple[str, str, str]:
    return (f"{t}.{{i}}", f"{f}_{{i}}", kind)


def _conv_block(t: str, f: str) -> List[Tuple[str, str, str]]:
    """A ``ConvAttentionLayer`` (and the lightconv decoder layer's extras)."""
    return [*[(f"{t}.{n}", f"{f}/{n}", "norm")
              for n in ("conv_layer_norm", "final_layer_norm", "encoder_attn_layer_norm")],
            *[(f"{t}.{n}", f"{f}/{n}", "dense") for n in ("linear1", "linear2", "fc1", "fc2")],
            (f"{t}.conv", f"{f}/conv", "param_weight"),
            (f"{t}.conv.weight_linear", f"{f}/conv/weight_linear", "dense_nobias"),
            *[(f"{t}.encoder_attn.{p}", f"{f}/encoder_attn/{p}", "dense")
              for p in ("q_proj", "k_proj", "v_proj", "out_proj")]]


_FCONV_LM = [("embed", "embed", "embed"), ("pos", "pos", "embed"),
             *_dense("proj_in", "proj_out", "out"), ("conv.{i}.conv", "conv_{i}/conv", "dense")]
_FCONV = [*[(n, n, "embed") for n in ("src_embed", "tgt_embed", "src_pos", "tgt_pos")],
          *_dense("enc_proj_in", "enc_proj_out", "dec_proj_in", "dec_proj_out", "out_proj"),
          ("enc_conv.{i}.conv", "enc_conv_{i}/conv", "dense"),
          ("dec_conv.{i}.conv", "dec_conv_{i}/conv", "dense"),
          _per_layer("attn_q", "attn_q"), _per_layer("attn_o", "attn_o")]
_RULES["fconv"] = _FCONV
_RULES["fconv_lm"] = _FCONV_LM
_RULES["fconv_self_att"] = [
    *_FCONV, _per_layer("attn_gate", "attn_gate"),
    *[(f"self_attn.{{i}}.{p}", f"self_attn_{{i}}/{p}", "dense")
      for p in ("q_proj", "k_proj", "v_proj", "out_proj")],
    *[(f"pretrained.{t}", f"pretrained/{f}", kind) for t, f, kind in _FCONV_LM],
    *_dense("gate1", "gate2", "lm_proj")]
_RULES["lightconv"] = [("embed_tokens", "embed_tokens", "embed"),
                       ("tgt_embed_tokens", "tgt_embed_tokens", "embed"),
                       *_conv_block("enc.{i}", "enc_{i}"), *_conv_block("dec.{i}", "dec_{i}"),
                       ("enc_norm", "enc_norm", "norm"), ("dec_norm", "dec_norm", "norm"),
                       ("output_projection", "output_projection", "dense_nobias")]
_RULES["lightconv_lm"] = [("embed", "embed", "embed"), *_conv_block("layers.{i}", "layers_{i}"),
                          ("norm", "norm", "norm"),
                          ("output_projection", "output_projection", "dense_nobias")]
_LSTM_ENCODER = [*_rnn("enc_rnn.{i}", "enc_rnn_{i}"), *_rnn("enc_rnn_rev.{i}", "enc_rnn_rev_{i}")]
_RULES["lstm"] = [("src_embed", "src_embed", "embed"), ("tgt_embed", "tgt_embed", "embed"),
                  *_LSTM_ENCODER, *_rnn("dec_rnn.{i}", "dec_rnn_{i}"),
                  ("attention.input_proj", "attention/input_proj", "dense_nobias"),
                  ("attention.output_proj", "attention/output_proj", "dense_nobias"),
                  ("output_projection", "output_projection", "dense_nobias")]
_RULES["lstm_lm"] = [("embed", "embed", "embed"), *_rnn("rnn.{i}", "rnn_{i}"),
                     ("out_proj_dim", "out_proj_dim", "dense"),
                     ("output_projection", "output_projection", "dense_nobias")]
# the JAX classifier builds its GRUCell in its own compact scope, so the
# cell's layers sit at ``GRUCell_0/`` and not under ``rnn/cell/``
_RULES["rnn_classifier"] = [("embed", "embed", "embed"),
                            ("rnn.cell.{g}", "GRUCell_0/{g}", "dense_opt_bias"),
                            ("classifier", "classifier", "dense")]
_RULES["dummy_model"] = [("embed", "embed", "embed"), ("out_proj", "out_proj", "dense"),
                         _per_layer("attn_ln", "attn_ln", "norm"),
                         _per_layer("ffn_ln", "ffn_ln", "norm"),
                         *[_per_layer(n, n) for n in ("qkv", "attn_skip", "attn_out", "ffn_up",
                                                      "ffn_down")]]
_RULES["s2t_berard"] = [("conv.{i}", "conv_{i}", "conv2d"), *_LSTM_ENCODER,
                        ("embed_tokens", "embed_tokens", "embed"),
                        *_rnn("dec_rnn.{i}", "dec_rnn_{i}"),
                        ("attention.query_proj", "attention/query_proj", "dense"),
                        ("attention.context_proj", "attention/context_proj", "dense_nobias"),
                        ("attention.score_proj", "attention/score_proj", "dense_nobias"),
                        ("output_projection", "output_projection", "dense")]

# placeholder of a template -> what it matches: ``{i}`` a layer index, ``{g}``
# a language group
_SLOTS = {"i": r"\d+", "g": r"[^./]+"}


def _pattern(template: str) -> "re.Pattern[str]":
    out = re.escape(template)
    for name, rx in _SLOTS.items():
        out = out.replace(re.escape("{" + name + "}"), f"(?P<{name}>{rx})")
    return re.compile(out + "$")


def _fill(template: str, match: "re.Match[str]") -> str:
    for name, value in match.groupdict().items():
        template = template.replace("{" + name + "}", value)
    return template


class _Table:
    """The rules of one model, matched from either side."""

    def __init__(self, rules):
        self.rules = [(t, f, kind, _pattern(t), _pattern(f)) for t, f, kind in rules]

    def from_flax(self, module: str) -> Tuple[str, str]:
        """flax module path ('a/b_3/c') -> (torch module, kind)."""
        for t, _, kind, _, fx in self.rules:
            m = fx.match(module)
            if m:
                return _fill(t, m), kind
        raise KeyError(module)

    def from_torch(self, module: str) -> Tuple[str, str]:
        """torch module ('a.b.3.c') -> (flax module path, kind)."""
        for _, f, kind, tx, _ in self.rules:
            m = tx.match(module)
            if m:
                return _fill(f, m), kind
        raise KeyError(module)


_TABLES = {name: _Table(rules) for name, rules in _RULES.items()}


def _flatten(tree: Mapping[str, Any], path: Path = ()) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + (str(k),)))
        else:
            out[path + (str(k),)] = v
    return out


def _unflatten(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _strip_variables(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def _flax_to_torch_names(table: _Table, leaves: Iterable[Path]) -> Dict[Path, Tuple[str, str]]:
    """flax leaf path -> (torch key, kind); raises on a leaf no rule names
    and on a module that lacks one of its kind's required leaves."""
    modules: Dict[str, Dict[str, Path]] = {}
    for path in leaves:
        modules.setdefault("/".join(path[:-1]), {})[path[-1]] = path
    out, unknown = {}, []
    for module, have in modules.items():
        try:
            tmod, kind = table.from_flax(module)
        except KeyError:
            unknown += [f"{module}/{leaf}" for leaf in have]
            continue
        spec = {fl: (tl, req) for tl, fl, req in _LEAVES[kind]}
        for leaf, path in have.items():
            if leaf not in spec:
                unknown.append(f"{module}/{leaf}")
                continue
            out[path] = (f"{tmod}.{spec[leaf][0]}" if tmod else spec[leaf][0], kind)
        for fl, (_, req) in spec.items():
            if req and fl not in have:
                raise KeyError(f"flax tree is missing {module}/{fl}")
    if unknown:
        raise ValueError(f"unconsumed flax parameters: {sorted(unknown)[:20]}")
    return out


def _from_flax(model: str, tree: Mapping[str, Any], raw: bool = False
               ) -> Dict[str, torch.Tensor]:
    """A flax tree -> {torch key: fp32 tensor}, each a copy of its leaf;
    ``raw`` keeps each leaf in its flax layout (an optimizer state kept in
    that layout). The layouts are permuted by torch, on all the host's
    threads (numpy's transpose takes one)."""
    flat = _flatten(_strip_variables(tree))
    names = _flax_to_torch_names(_TABLES[model], flat)
    out = {}
    for path, (key, kind) in names.items():
        a = np.asarray(flat[path], dtype=np.float32)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        axes = None if raw else _torch_axes(kind, path[-1], t.dim())
        out[key] = (t if axes is None else t.permute(axes)).clone(
            memory_format=torch.contiguous_format)
    return out


def torch_to_flax_path(model: str, key: str) -> Tuple[Path, str]:
    """A state-dict key of the port's ``model`` (a table name: 'interlingua',
    's2t', 'wav2vec2', 'transformer', 'transformer_lm') -> (its flax leaf path
    without the 'params' root, kind)."""
    module, _, leaf = key.rpartition(".")
    fmod, kind = _TABLES[model].from_torch(module)
    flax_leaf = {tl: fl for tl, fl, _ in _LEAVES[kind]}.get(leaf)
    if flax_leaf is None:
        raise KeyError(key)
    return (tuple(fmod.split("/")) if fmod else ()) + (flax_leaf,), kind


def _to_flax(model: str, state: Mapping[str, Any], raw: bool = False) -> Dict[str, Any]:
    """{torch key: tensor or None} -> the flax tree of numpy leaves (None
    keeps its place as an empty ``{}``, what a masked leaf is in optax);
    ``raw`` leaves are in the flax layout already. A tensor's layout is
    permuted by torch on its own device before it is copied to the host."""
    flat = {}
    for key, value in state.items():
        path, kind = torch_to_flax_path(model, key)
        if value is None:
            flat[path] = {}
            continue
        leaf = key.rpartition(".")[2]
        if torch.is_tensor(value):
            t = value.detach()
            axes = None if raw else _flax_axes(kind, leaf, t.dim())
            a = (t if axes is None else t.permute(axes).contiguous()).cpu().numpy()
        else:
            a = np.asarray(value)
            axes = None if raw else _flax_axes(kind, leaf, a.ndim)
            a = a if axes is None else a.transpose(axes)
        flat[path] = np.ascontiguousarray(a)
    return _unflatten(flat)


def checkpoint_axes(model: torch.nn.Module) -> Dict[torch.nn.Parameter, Tuple[int, ...]]:
    """Each parameter of a port model -> the permutation of its axes that
    gives its flax layout (``tensor.permute(perm)``): reversed for a dense
    or conv ``weight`` (``kernel [in, out]`` / ``[k, in/groups, out]``),
    the identity otherwise. Adafactor factors its second moments over the
    flax layout's axes."""
    kind_of = model_kind(model)
    out = {}
    for name, p in model.named_parameters():
        _, kind = torch_to_flax_path(kind_of, name)
        if name.endswith(".weight") and kind in ("conv2d", "stacked_dense"):
            out[p] = (2, 3, 1, 0) if kind == "conv2d" else (0, 2, 1)
            continue
        rev = name.endswith(".weight") and kind.startswith(("dense", "conv"))
        out[p] = tuple(range(p.dim()))[::-1] if rev else tuple(range(p.dim()))
    return out


def wav2vec2_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``Wav2Vec2Encoder`` params -> state dict of the port's
    ``Wav2Vec2Encoder``."""
    return _from_flax("wav2vec2", tree)


def params_from_flax(tree: Mapping[str, Any], model: str = "interlingua"
                     ) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``model`` (a table name: by default
    ``ChimeraInterlinguaModel``) -> state dict of the port's model."""
    return _from_flax(model, tree)


def model_kind(model: torch.nn.Module) -> str:
    """The table name of a port model: ``interlingua``, ``s2t``,
    ``transformer``, ``transformer_lm``, ``transformer_lm_char`` (a
    language model with character embeddings) or a non-autoregressive
    model's name (``cmlm_transformer``, ``nonautoregressive_transformer``,
    ``iterative_nonautoregressive_transformer``, ``nacrf_transformer``,
    ``levenshtein_transformer``, ``insertion_transformer``), ``bart``,
    ``multilingual_transformer``, or of the wav2vec family ``wav2vec_ctc``,
    ``wav2vec_seq2seq``, ``wav2vec2_pretrain`` (either quantizer) or
    ``wav2vec`` (v1), or ``masked_lm``, or a zoo model's name (``lstm`` for
    ``simple_lstm`` too)."""
    cfg = getattr(model, "cfg", None)
    if getattr(cfg, "character_embeddings", False):
        return "transformer_lm_char"
    if type(model).__name__ == "NATransformer":
        if cfg.crf_lowrank > 0:
            return "nacrf_transformer"
        return ("iterative_nonautoregressive_transformer" if cfg.train_steps > 1
                else "nonautoregressive_transformer")
    return {"ChimeraInterlinguaModel": "interlingua", "S2TTransformerModel": "s2t",
            "TransformerModel": "transformer", "TransformerLM": "transformer_lm",
            "Wav2Vec2Encoder": "wav2vec2", "CMLMTransformer": "cmlm_transformer",
            "LevenshteinTransformer": "levenshtein_transformer",
            "InsertionTransformer": "insertion_transformer", "BARTModel": "bart",
            "MultilingualTransformer": "multilingual_transformer",
            "Wav2VecCtcModel": "wav2vec_ctc", "Wav2VecSeq2SeqModel": "wav2vec_seq2seq",
            "Wav2Vec2PretrainModel": "wav2vec2_pretrain",
            "Wav2VecV1Model": "wav2vec", "MaskedLMModel": "masked_lm",
            "FConvModel": "fconv", "FConvLM": "fconv_lm", "FConvSelfAttModel": "fconv_self_att",
            "LightConvModel": "lightconv", "LightConvLM": "lightconv_lm", "LSTMModel": "lstm",
            "LSTMLM": "lstm_lm", "RNNClassifier": "rnn_classifier", "DummyModel": "dummy_model",
            "BerardModel": "s2t_berard", "GPT2LM": "hf_gpt2",
            "PipelinedTransformerLM": "transformer_lm_pipe"}[type(model).__name__]


def s2t_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``S2TTransformerModel`` params -> state dict of the port's
    ``S2TTransformerModel`` (tied decoder embeddings)."""
    return _from_flax("s2t", tree)


def params_to_flax(state_dict: Mapping[str, torch.Tensor], model: str = "interlingua"
                   ) -> Dict[str, Any]:
    """State dict of the port's model -> the flax variables dict
    ``{"params": …}`` of numpy fp32 arrays the JAX package's checkpoints
    hold (the inverse of ``params_from_flax``)."""
    return {"params": _to_flax(model, state_dict)}


# ---------------------------------------------------------- optimizer state

# layout -> optax's chain below the global-norm clip and the L2 decay, one
# entry a position: "schedule" (the schedule's own count), {} (a state
# without fields), or the fields of the optimizer's state: "count" (its own
# update count) and trees over the parameters. Read from the trees the JAX
# trainer writes (flax ``serialization.to_state_dict`` of ``tx.init``).
OPTAX_CHAINS: Dict[str, Tuple[Any, ...]] = {
    "adam": (("count", "mu", "nu"), "schedule"),
    "adamw": (("count", "mu", "nu"), {}, "schedule"),
    # scale_by_factored_rms, clip_by_block_rms, the schedule,
    # scale_by_param_block_rms, [add_decayed_weights,] scale(-1)
    "adafactor": (("count", "v_row", "v_col", "v"), {}, "schedule", {}, {}),
    "adafactor_decay": (("count", "v_row", "v_col", "v"), {}, "schedule", {}, {}, {}),
    "adagrad": (("sum_of_squares",), "schedule"),
    # optax.adadelta's own add_decayed_weights(0), then scale_by_adadelta
    "adadelta": ({}, ("e_g", "e_x"), "schedule"),
    "sgd": ({}, "schedule"),  # optax.sgd without momentum: identity
    "momentum": (("trace",), "schedule"),  # sgd --momentum, nag
    "adamax": (("count", "mu", "nu"), "schedule"),
    "lamb": (("count", "mu", "nu"), {}, {}, "schedule"),
}


def _wrap_chain(chain: Dict[str, Any], *, clip: bool, l2: bool, masked: bool) -> Dict[str, Any]:
    """The L2 decay (``_with_l2``: ``chain(add_decayed_weights, tx)``), the
    clip (``chain(clip_by_global_norm, ...)``) and the ``--fix-*`` mask
    (``multi_transform``) around a chain."""
    if l2:
        chain = {"0": {}, "1": chain}
    if clip:
        chain = {"0": {}, "1": chain}
    if masked:
        chain = {"inner_states": {"train": {"inner_state": chain},
                                  "freeze": {"inner_state": {}}}}
    return chain


def _unwrap_chain(tree: Mapping[str, Any], *, clip: bool, l2: bool, masked: bool):
    chain = tree["inner_states"]["train"]["inner_state"] if masked else tree
    if clip:
        chain = chain["1"]
    if l2:
        chain = chain["1"]
    return chain


def optimizer_state_to_optax(layout: str, fields: Mapping[str, Optional[Mapping[str, Any]]],
                             count: int, schedule_count: int, *, model: str = "interlingua",
                             clip: bool = False, l2: bool = False, raw: bool = False
                             ) -> Dict[str, Any]:
    """An optimizer's state -> optax's tree of the chain ``layout``
    (``OPTAX_CHAINS``). ``fields[name]`` is the parameter's state by field
    (numpy or tensors in the port's layout, or with ``raw`` in the flax
    layout already), or None for a frozen parameter (its leaves are ``{}``:
    the ``multi_transform`` layout); ``count`` is the optimizer's own update
    count, ``schedule_count`` the schedule's."""
    masked = any(f is None for f in fields.values())
    chain = {}
    for i, entry in enumerate(OPTAX_CHAINS[layout]):
        if entry == "schedule":
            chain[str(i)] = {"count": np.asarray(schedule_count, np.int32)}
        elif isinstance(entry, dict):
            chain[str(i)] = {}
        else:
            chain[str(i)] = {
                f: np.asarray(count, np.int32) if f == "count" else
                {"params": _to_flax(model, {n: None if s is None else s[f]
                                            for n, s in fields.items()}, raw=raw)}
                for f in entry}
    return _wrap_chain(chain, clip=clip, l2=l2, masked=masked)


def optimizer_state_from_optax(tree: Mapping[str, Any], template: Mapping[str, Any],
                               layout: str, *, model: str = "interlingua", clip: bool = False,
                               l2: bool = False, masked: bool = False, raw: bool = False
                               ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int, int]:
    """optax's tree -> ({field: {parameter name: tensor}}, the optimizer's
    count, the schedule's count): the inverse of
    ``optimizer_state_to_optax``. ``template`` is the tree of this
    optimizer (``optimizer_state_to_optax`` of its own state): a tree of
    another layout or shape raises ValueError, on which a caller keeps a
    fresh state as the JAX package's ``load_state`` does. A frozen
    parameter's ``{}`` leaves flatten away."""
    _same_layout(tree, template)
    chain = _unwrap_chain(tree, clip=clip, l2=l2, masked=masked)
    fields: Dict[str, Dict[str, torch.Tensor]] = {}
    count, schedule_count = 0, 0
    for i, entry in enumerate(OPTAX_CHAINS[layout]):
        node = chain[str(i)]
        if entry == "schedule":
            schedule_count = int(np.asarray(node["count"]))
        elif not isinstance(entry, dict):
            for f in entry:
                if f == "count":
                    count = int(np.asarray(node["count"]))
                else:
                    fields[f] = _from_flax(model, node[f]["params"], raw=raw)
    return fields, count, schedule_count


def _same_layout(got: Any, want: Any, path: str = "") -> None:
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping) or set(got) != set(want):
            raise ValueError(f"optimizer state layout differs at {path or '/'}: "
                             f"{sorted(got) if isinstance(got, Mapping) else type(got).__name__}"
                             f" vs {sorted(want)}")
        for k in want:
            _same_layout(got[k], want[k], f"{path}/{k}")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"optimizer state {path}: shape {np.shape(got)} vs {np.shape(want)}")
