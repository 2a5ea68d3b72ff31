"""Model modules of the serving path and of the triplet fine-tune, and the
registry of the architectures that are ported: ``s2t_transformer_w2v2_interlingua_base``,
the plain w2v2 + Transformer ST model ``s2t_transformer_w2v2`` (the
interlingua model without its memory bank) with its five presets, the seven fbank ``s2t_transformer*`` presets, the 23 presets of the
Transformer family (``transformer*``, ``transformer_lm*``) and the six
non-autoregressive models with their 12 presets (``cmlm_transformer*``,
``*nonautoregressive_transformer*``, ``nacrf_transformer``,
``levenshtein_transformer*``, ``insertion_transformer``), ``bart`` with its
five ``bart*`` / ``mbart*`` presets and ``multilingual_transformer`` with
its two, and the wav2vec family: ``wav2vec_ctc`` and ``wav2vec_seq2seq``
(speech recognition), ``wav2vec2`` / ``wav2vec2_large`` and
``wav2vec2_quasiwave`` / ``wav2vec2_quasiwave_base`` (pre-training) and
``wav2vec`` (v1), and the masked-LM family: ``masked_lm``, ``roberta``,
``camembert`` and ``xlmr`` with the ten ``roberta*`` / ``bert*`` / ``xlm*`` /
``camembert`` / ``masked_lm`` presets, and ``transformer_from_pretrained_xlm``,
and the convolutional and recurrent zoo: ``fconv`` / ``fconv_lm`` /
``fconv_self_att``, ``lightconv`` / ``lightconv_lm``, ``lstm`` /
``lstm_lm`` / ``simple_lstm``, ``rnn_classifier``, ``dummy_model`` and
``s2t_berard`` with their 33 presets, GPT-2 (``hf_gpt2`` and its
``_medium`` / ``_large`` / ``_xl`` presets) and the stacked pipeline LM
``transformer_lm_pipe`` (counterpart of the registrations in
chimera_st_tpu/models/).

A registered model constructor takes ``(cfg_dict, device)``; an architecture is a
function that fills a config dict with its preset's defaults. A field the
port cannot honour raises instead of being dropped."""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..config.registry import ARCHITECTURES, MODELS, register_model, register_model_architecture
from . import bart as _bart
from . import berard as _berard
from . import fconv as _fconv
from . import fconv_self_att as _fconv_sa
from . import hf_gpt2 as _gpt2
from . import lightconv_mt as _lightconv
from . import lm_extra as _lm_extra
from . import lstm as _lstm
from . import masked_lm as _mlm
from . import multilingual_transformer as _multi
from . import nat_cmlm as _cmlm
from . import nat_insertion as _ins
from . import nat_levenshtein as _lev
from . import nat_vanilla as _nat
from . import pipeline_lm as _pipe_lm
from . import roberta_hub as _roberta_hub
from . import s2t_transformer as _s2t
from . import transformer_mt as _mt
from . import wav2vec2_asr as _asr
from . import wav2vec2_pretraining as _w2v2_pt
from . import wav2vec_v1 as _w2v1
from .interlingua import ChimeraInterlinguaModel, InterlinguaConfig


def _known(config_cls, cfg_dict: Dict) -> Dict:
    """The fields of ``config_cls`` in ``cfg_dict``; sequences as tuples."""
    names = {f.name for f in dataclasses.fields(config_cls)}
    out = {k: v for k, v in cfg_dict.items() if k in names}
    for k in ("conv_kernel_sizes", "w2v2_conv_spec"):
        if isinstance(out.get(k), (list, tuple)):
            out[k] = tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in out[k])
    return out


@register_model("s2t_transformer_w2v2_interlingua")
def build_interlingua_model(cfg_dict: Dict, device="cuda") -> ChimeraInterlinguaModel:
    return ChimeraInterlinguaModel(InterlinguaConfig(**_known(InterlinguaConfig, cfg_dict)),
                                   device=device)


@register_model_architecture("s2t_transformer_w2v2_interlingua",
                             "s2t_transformer_w2v2_interlingua_base")
def interlingua_base(cfg: Dict) -> Dict:
    """``InterlinguaConfig``'s own defaults are this preset; what the preset
    adds is that the decoder follows the encoder's widths."""
    d = dict(cfg)
    base = InterlinguaConfig()
    d.setdefault("decoder_embed_dim", d.get("encoder_embed_dim", base.encoder_embed_dim))
    d.setdefault("decoder_ffn_dim", d.get("encoder_ffn_dim", base.encoder_ffn_dim))
    return d


# the plain w2v2 + Transformer ST model of the Chimera paper (no memory
# bank): the interlingua builder with no_interlingua=True (JAX
# models/interlingua.py:419-466)
@register_model("s2t_transformer_w2v2")
def build_s2t_w2v2_model(cfg_dict: Dict, device="cuda") -> ChimeraInterlinguaModel:
    return build_interlingua_model({**cfg_dict, "no_interlingua": True}, device)


def _s2t_w2v2_s(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_embed_dim", 256)
    d.setdefault("encoder_ffn_dim", 256 * 8)
    d.setdefault("encoder_heads", 4)
    d.setdefault("decoder_heads", 4)
    return interlingua_base(d)


def _s2t_w2v2_sp(cfg: Dict) -> Dict:
    return _s2t_w2v2_s({"encoder_layers": 16, **cfg})


# asr_s differs from _s in the reference only by the trunk checkpoint it
# loads (an ASR-fine-tuned wav2vec2): a --w2v2-model-path concern
for _arch, _preset in (("s2t_transformer_w2v2", interlingua_base),
                       ("s2t_transformer_w2v2_s", _s2t_w2v2_s),
                       ("s2t_transformer_w2v2yr_s", _s2t_w2v2_s),
                       ("s2t_transformer_w2v2_sp", _s2t_w2v2_sp),
                       ("s2t_transformer_w2v2asr_s", _s2t_w2v2_s)):
    register_model_architecture("s2t_transformer_w2v2", _arch)(_preset)


@register_model("s2t_transformer")
def build_s2t_model(cfg_dict: Dict, device="cuda") -> _s2t.S2TTransformerModel:
    return _s2t.S2TTransformerModel(
        _s2t.S2TTransformerConfig(**_known(_s2t.S2TTransformerConfig, cfg_dict)), device=device)


for _arch, _preset in _s2t.ARCHITECTURES.items():
    register_model_architecture("s2t_transformer", _arch)(_preset)

# the Transformer family, the non-autoregressive family, BART, the
# multilingual transformer, the wav2vec family and the masked-LM family
NAT_MODEL_BUILDERS = {
    "cmlm_transformer": _cmlm.build_cmlm,
    "nonautoregressive_transformer": _nat.build_nat,
    "iterative_nonautoregressive_transformer": _nat.build_inat,
    "nacrf_transformer": _nat.build_nacrf,
    "levenshtein_transformer": _lev.build_levenshtein,
    "insertion_transformer": _ins.build_insertion,
}
# the convolutional and recurrent zoo
_ZOO = (_fconv, _fconv_sa, _lightconv, _lstm, _lm_extra, _berard)
ZOO_MODEL_BUILDERS = {k: v for m in _ZOO for k, v in m.MODEL_BUILDERS.items()}
ZOO_ARCHITECTURES = {k: v for m in _ZOO for k, v in m.ARCHITECTURES.items()}
NAT_ARCHITECTURES = {**_cmlm.ARCHITECTURES, **_nat.ARCHITECTURES, **_lev.ARCHITECTURES,
                     **_ins.ARCHITECTURES}
for _name, _build in {**_mt.MODEL_BUILDERS, **NAT_MODEL_BUILDERS, "bart": _bart.build_bart,
                      "multilingual_transformer": _multi.build_multilingual,
                      **_asr.MODEL_BUILDERS, **_w2v2_pt.MODEL_BUILDERS,
                      **_w2v1.MODEL_BUILDERS, **_mlm.MODEL_BUILDERS,
                      **_roberta_hub.MODEL_BUILDERS, **ZOO_MODEL_BUILDERS,
                      "hf_gpt2": _gpt2.build_hf_gpt2, **_pipe_lm.MODEL_BUILDERS}.items():
    register_model(_name)(_build)
for _arch, (_model, _preset) in {**_mt.ARCHITECTURES, **NAT_ARCHITECTURES,
                                 **_bart.ARCHITECTURES, **_multi.ARCHITECTURES,
                                 **_asr.ARCHITECTURES, **_w2v2_pt.ARCHITECTURES,
                                 **_w2v1.ARCHITECTURES, **_mlm.ARCHITECTURES,
                                 **_roberta_hub.ARCHITECTURES, **ZOO_ARCHITECTURES,
                                 **_gpt2.ARCHITECTURES, **_pipe_lm.ARCHITECTURES}.items():
    register_model_architecture(_model, _arch)(_preset)

__all__ = ["ARCHITECTURES", "MODELS", "ChimeraInterlinguaModel", "InterlinguaConfig",
           "build_interlingua_model", "build_s2t_model", "build_s2t_w2v2_model"]
