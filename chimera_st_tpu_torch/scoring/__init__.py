from ..config.registry import SCORERS
from . import bleu, wer  # noqa: F401 — registration side effects


def build_scorer(cfg, tgt_dict=None):
    """``{"_name": "sacrebleu" | "bleu" | "wer", ...}`` -> scorer. ``chrf``
    is not ported yet (ROADMAP A14)."""
    name = cfg.get("_name", "sacrebleu") if isinstance(cfg, dict) else str(cfg)
    if name == "chrf":
        raise NotImplementedError(f"--scoring {name} is not ported yet (ROADMAP A14)")
    return SCORERS.get(name)(cfg if isinstance(cfg, dict) else {}, tgt_dict)
