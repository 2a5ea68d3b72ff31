from ..config.registry import SCORERS
from . import bleu, chrf, wer  # noqa: F401 — registration side effects


def build_scorer(cfg, tgt_dict=None):
    """``{"_name": "sacrebleu" | "bleu" | "chrf" | "wer", ...}`` -> scorer."""
    name = cfg.get("_name", "sacrebleu") if isinstance(cfg, dict) else str(cfg)
    return SCORERS.get(name)(cfg if isinstance(cfg, dict) else {}, tgt_dict)
