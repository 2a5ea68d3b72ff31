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

# registry -> {name the JAX package registers and the port does not yet:
# the ROADMAP item that ports it}
# (empty: every name is ported; the table stays for the next one)
UNPORTED: Dict[str, Dict[str, str]] = {}


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
