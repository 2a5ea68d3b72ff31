"""Translation over binarized parallel text (counterpart of
chimera_st_tpu/tasks/translation.py): the MT pre-training stage of the
Chimera recipe (``recipes/train-en2any-MT.sh``), the interlingua model's
text branch trained on ``chimera-torch-preprocess`` output.

Data dir layout: ``dict.{src}.txt``, ``dict.{tgt}.txt`` and
``{split}.{src}-{tgt}.{lang}.bin/idx``. The task is text-only: its batches
never carry audio, so the train CLI masks the audio trunk out of the
optimizer (``optim/freeze.py`` ``auto_text_only_fixes``)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

from ..config.registry import register_task
from ..data.batching import round16
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.language_pair import LanguagePairDataset
from .base import ChimeraTask

logger = logging.getLogger(__name__)


def collate_pairs(dataset, idx):
    """Source and target each padded to a multiple of 16 of its own longest
    row, as the JAX text tasks pad them (the bucket edge is unused)."""
    samples = [dataset[int(i)] for i in idx]
    src_max = round16(max(len(s["source"]) for s in samples))
    tgt_max = round16(max(len(s["target"]) for s in samples))
    return dataset.collater(samples, src_target_len=src_max, tgt_target_len=tgt_max)


@register_task("translation")
class TranslationTask(ChimeraTask):
    text_only = True

    def __init__(self, cfg: Dict, src_dict: Dictionary, tgt_dict: Dictionary):
        super().__init__(cfg)
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        src, tgt = cfg.get("source_lang"), cfg.get("target_lang")
        if src is None or tgt is None:
            src, tgt = cls.infer_language_pair(root)
        cfg["source_lang"], cfg["target_lang"] = src, tgt
        src_dict = cls.load_dictionary(str(root / f"dict.{src}.txt"))
        tgt_dict = cls.load_dictionary(str(root / f"dict.{tgt}.txt"))
        if src_dict.pad() != tgt_dict.pad():
            raise ValueError("source and target dictionaries disagree on the pad index")
        logger.info(f"translation {src}->{tgt}: dicts {len(src_dict)}/{len(tgt_dict)}")
        return cls(cfg, src_dict, tgt_dict)

    @staticmethod
    def infer_language_pair(root: Path):
        """(src, tgt) from the first ``train.{src}-{tgt}.*.idx`` file."""
        for p in sorted(root.glob("train.*-*.idx")):
            parts = p.name.split(".")
            if len(parts) >= 3 and "-" in parts[1]:
                src, tgt = parts[1].split("-")
                return src, tgt
        raise FileNotFoundError(f"cannot infer language pair under {root}")

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        src, tgt = self.cfg["source_lang"], self.cfg["target_lang"]
        prefix = str(root / f"{split}.{src}-{tgt}.")
        self.datasets[split] = LanguagePairDataset(
            MMapIndexedDataset(prefix + src), MMapIndexedDataset(prefix + tgt),
            self.src_dict, self.tgt_dict)

    @property
    def source_dictionary(self) -> Dictionary:
        return self.src_dict

    @property
    def target_dictionary(self) -> Dictionary:
        return self.tgt_dict

    def collate_indices(self, dataset, idx, target_len: Optional[int] = None):
        return collate_pairs(dataset, idx)
