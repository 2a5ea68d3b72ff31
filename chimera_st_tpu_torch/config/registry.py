"""Plugin registries (own copy of chimera_st_tpu/config/registry.py).

Replaces the reference's closure-based ``setup_registry`` and bespoke
model/task REGISTRY dicts (reference: fairseq/registry.py:16-60,
fairseq/models/__init__.py, fairseq/tasks/__init__.py) with one generic
:class:`Registry` type. Architectures are parameter-default presets layered on
a registered model (reference: ``register_model_architecture``).

A name that the JAX package registers and the port does not yet is listed in
``UNPORTED`` with the ROADMAP item that ports it: ``Registry.get`` raises
``NotImplementedError`` naming that item for it, and ``KeyError`` for a name
neither package knows. ``tests/test_torch_registry_miss.py`` holds the table
to both packages' registries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, key: str, value: Optional[Any] = None) -> Callable:
        def _do(v):
            if key in self._entries and self._entries[key] is not v:
                raise ValueError(f"duplicate {self.name} registration: {key!r}")
            self._entries[key] = v
            return v

        if value is not None:
            return _do(value)
        return _do

    def get(self, key: str) -> Any:
        item = UNPORTED.get(self.name, {}).get(key)
        if item is not None and key not in self._entries:
            raise NotImplementedError(f"{self.name} {key!r} is not ported yet (ROADMAP {item})")
        if key not in self._entries:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.name} {key!r} (known: {known})")
        return self._entries[key]

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return sorted(self._entries)

    def items(self):
        return self._entries.items()


REGISTRIES: Dict[str, Registry] = {}

_A14D_ARCHITECTURES = (
    "dummy_model", "dynamicconv_iwslt_de_en", "dynamicconv_lm", "fconv", "fconv_iwslt_de_en",
    "fconv_lm", "fconv_lm_dauphin_gbw", "fconv_lm_dauphin_wikitext103", "fconv_self_att",
    "fconv_self_att_wp", "fconv_wmt_en_de", "fconv_wmt_en_fr", "fconv_wmt_en_ro", "lightconv",
    "lightconv_iwslt_de_en", "lightconv_lm", "lightconv_lm_gbw", "lightconv_wmt_en_de",
    "lightconv_wmt_en_de_big", "lightconv_wmt_en_fr_big", "lightconv_wmt_zh_en_big", "lstm",
    "lstm_lm", "lstm_luong_wmt_en_de", "lstm_wiseman_iwslt_de_en", "pytorch_tutorial_rnn",
    "rnn_classifier", "s2t_berard", "s2t_berard_256_3_3", "s2t_berard_512_3_2",
    "s2t_berard_512_5_3", "simple_lstm", "tutorial_simple_lstm")
_A14D_MODELS = ("dummy_model", "fconv", "fconv_lm", "fconv_self_att", "lightconv",
                "lightconv_lm", "lstm", "lstm_lm", "rnn_classifier", "s2t_berard", "simple_lstm")

# registry -> {name the JAX package registers and the port does not yet:
# the ROADMAP item that ports it}
UNPORTED: Dict[str, Dict[str, str]] = {
    "architecture": {**dict.fromkeys(_A14D_ARCHITECTURES, "A14d"),
                     **dict.fromkeys(("hf_gpt2", "hf_gpt2_large", "hf_gpt2_medium",
                                      "hf_gpt2_xl"), "A14e"),
                     "transformer_lm_pipe": "A14e"},
    "model": {**dict.fromkeys(_A14D_MODELS, "A14d"), "hf_gpt2": "A14e",
              "transformer_lm_pipe": "A14e"},
    "task": dict.fromkeys(("dummy_lm", "dummy_masked_lm", "dummy_mt", "simple_classification"),
                          "A14d"),
    "criterion": dict.fromkeys(("label_smoothed_cross_entropy_with_alignment",
                                "simple_classification"), "A14d"),
}


def get_registry(kind: str) -> Registry:
    if kind not in REGISTRIES:
        REGISTRIES[kind] = Registry(kind)
    return REGISTRIES[kind]


TASKS = get_registry("task")
MODELS = get_registry("model")
ARCHITECTURES = get_registry("architecture")
CRITERIONS = get_registry("criterion")
OPTIMIZERS = get_registry("optimizer")
LR_SCHEDULERS = get_registry("lr_scheduler")
BPE = get_registry("bpe")
TOKENIZERS = get_registry("tokenizer")
SCORERS = get_registry("scoring")
SEARCH = get_registry("search")


def register_task(name: str):
    return TASKS.register(name)


def register_model(name: str):
    return MODELS.register(name)


def register_model_architecture(model_name: str, arch_name: str):
    """Register an architecture preset: a fn(cfg_dict) that fills defaults.

    The preset function mutates/returns a plain dict of model hyperparameters;
    ``ARCHITECTURES[arch] = (model_name, preset_fn)``.
    """

    def _wrap(fn):
        ARCHITECTURES.register(arch_name, (model_name, fn))
        return fn

    return _wrap


def register_criterion(name: str):
    return CRITERIONS.register(name)


def register_optimizer(name: str):
    return OPTIMIZERS.register(name)


def register_lr_scheduler(name: str):
    return LR_SCHEDULERS.register(name)


def register_bpe(name: str):
    return BPE.register(name)


def register_tokenizer(name: str):
    return TOKENIZERS.register(name)


def register_scorer(name: str):
    return SCORERS.register(name)


def register_search(name: str):
    return SEARCH.register(name)
