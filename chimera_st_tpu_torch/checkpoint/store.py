"""Native checkpoint store, read side (counterpart of
chimera_st_tpu/checkpoint/store.py and of the ``.ckpt`` branch of its
``cli/generate.py`` ``load_model_and_params``).

A ``.ckpt`` the JAX trainer wrote is one pickle: ``params`` and ``opt_state``
as trees of numpy arrays, ``step``, and ``extra`` with the run's ``model_cfg``
(arch name plus overrides), so the exact model rebuilds without repeating the
arch flags. Reading it needs numpy only. The parameter tree is carried across
with ``convert.params_from_flax`` / ``s2t_params_from_flax``; ``opt_state`` is
not read. Saving waits for the trainer (ROADMAP A10).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

SUFFIX = ".ckpt"


def load_native_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (flax parameter tree with numpy leaves, model_cfg dict)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "params" not in payload:
        raise ValueError(f"{path}: not a native checkpoint (no 'params' entry)")
    model_cfg = dict((payload.get("extra") or {}).get("model_cfg") or {})
    return payload["params"], model_cfg
