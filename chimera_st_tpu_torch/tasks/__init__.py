from ..config.registry import TASKS
from .base import ChimeraTask
from . import (  # noqa: F401 — registration
    audio_pretraining, denoising, dummy, joint_task, language_modeling, lm_tail, masked_lm,
    multilingual_translation, sentence_prediction, speech_to_text, translation,
    translation_extra, translation_lev, translation_tts, triplet)


def setup_task(cfg: dict, **kwargs) -> ChimeraTask:
    name = cfg.get("_name")
    return TASKS.get(name).setup_task(cfg, **kwargs)


__all__ = ["ChimeraTask", "setup_task", "TASKS"]
