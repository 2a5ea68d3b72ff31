"""Translation with synthesized source audio (counterpart of
chimera_st_tpu/tasks/translation_tts.py): the binarized parallel text of
``translation`` whose rows may carry ``{index}.wav`` from ``audio_dirname``
(a directory, or a dict of one per split). A batch whose rows all carry a
wave has the triplet schema (``data/language_pair_tts.py``), its audio
padded to a multiple of 1280 samples, and trains the speech branch (K2 and
the trunk) through the triplet criterion; other batches are text.

The train CLIs of both packages declare no flag for ``audio_dirname``, so
from the command line this task trains as text; the audio path is reached
from Python (``setup_task({"_name": "translation_tts", "audio_dirname":
...})``)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..config.registry import register_task
from ..data.batching import round16
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.language_pair_tts import LanguagePairTTSDataset
from .translation import TranslationTask


@register_task("translation_tts")
class TranslationTTSTask(TranslationTask):
    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        src, tgt = self.cfg["source_lang"], self.cfg["target_lang"]
        prefix = str(root / f"{split}.{src}-{tgt}.")
        audio_dir = self.cfg.get("audio_dirname")
        if isinstance(audio_dir, dict):
            audio_dir = audio_dir.get(split)
        self.datasets[split] = LanguagePairTTSDataset(
            MMapIndexedDataset(prefix + src), MMapIndexedDataset(prefix + tgt),
            self.src_dict, self.tgt_dict, audio_dirname=audio_dir)

    def collate_indices(self, dataset, idx, target_len: Optional[int] = None):
        samples = [dataset[int(i)] for i in idx]
        src_max = round16(max(len(s["source"]) for s in samples))
        tgt_max = round16(max(len(s["target"]) for s in samples))
        audio_max = None
        if all("wave" in s for s in samples):
            audio_max = (max(len(s["wave"]) for s in samples) + 1279) // 1280 * 1280
        return dataset.collater(samples, src_target_len=src_max, tgt_target_len=tgt_max,
                                audio_target_len=audio_max)
