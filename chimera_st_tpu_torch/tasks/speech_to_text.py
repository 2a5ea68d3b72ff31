"""Speech-to-text task (counterpart of chimera_st_tpu/tasks/speech_to_text.py;
the BLEU-validating variant waits for fbank training, ROADMAP A10c)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

from ..config.registry import register_task
from ..data.dictionary import Dictionary
from ..data.manifests import S2TDataConfig, make_dataset_from_tsv
from .base import ChimeraTask

logger = logging.getLogger(__name__)


@register_task("speech_to_text")
class SpeechToTextTask(ChimeraTask):
    def __init__(self, cfg: Dict, tgt_dict: Dictionary, data_cfg: S2TDataConfig):
        super().__init__(cfg)
        self.tgt_dict = tgt_dict
        self.data_cfg = data_cfg

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        data_cfg = S2TDataConfig(str(root / cfg.get("config_yaml", "config_wave.yaml")))
        tgt_dict = cls.load_dictionary(str(root / data_cfg.vocab_filename))
        return cls(cfg, tgt_dict, data_cfg)

    def load_dataset(self, split: str, **kwargs):
        self.datasets[split] = make_dataset_from_tsv(
            self.cfg["data"],
            split,
            self.data_cfg,
            self.tgt_dict,
            split.startswith("train"),
        )

    @property
    def target_dictionary(self) -> Dictionary:
        return self.tgt_dict

    def lang_tag_indices(self):
        """Ids of <lang:xx> tags, stripped from hypotheses before scoring."""
        return {i for s, i in self.tgt_dict.indices.items() if s.startswith("<lang:")}
