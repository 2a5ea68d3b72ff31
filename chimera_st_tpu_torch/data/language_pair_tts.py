"""Parallel text with optional synthesized audio (own copy of
chimera_st_tpu/data/language_pair_tts.py): a row whose index has an
``{index}.wav`` in ``audio_dirname`` carries its waveform as ``wave``.

A batch in which every row has a wave also gets ``audio`` (float32, padded
with zeros to ``audio_target_len``), ``audio_padding_mask``,
``audio_lengths`` and the text side again as ``src_text`` /
``src_text_lengths``: the triplet criterion's schema, so text corpora feed
the speech branch. A batch with any row missing a wave stays text only."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from .audio import read_wav
from .batching import collate_tokens
from .language_pair import LanguagePairDataset


class LanguagePairTTSDataset(LanguagePairDataset):
    def __init__(self, *args, audio_dirname: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.audio_dirname = Path(audio_dirname) if audio_dirname else None

    def _wave_path(self, index: int) -> Optional[Path]:
        if self.audio_dirname is None:
            return None
        p = self.audio_dirname / f"{index}.wav"
        return p if p.is_file() else None

    def __getitem__(self, i: int) -> Dict[str, Any]:
        ex = super().__getitem__(i)
        wp = self._wave_path(i)
        if wp is not None:
            ex["wave"], _ = read_wav(str(wp))
        return ex

    def collater(self, samples: List[Dict], src_target_len: Optional[int] = None,
                 tgt_target_len: Optional[int] = None,
                 audio_target_len: Optional[int] = None) -> Dict[str, Any]:
        batch = super().collater(samples, src_target_len, tgt_target_len)
        if not batch:
            return batch
        samples = sorted(samples, key=lambda s: -len(s["source"]))
        if all("wave" in s for s in samples):
            waves = [s["wave"].astype(np.float32) for s in samples]
            audio = collate_tokens(waves, 0.0, target_len=audio_target_len, dtype=np.float32)
            lengths = np.asarray([len(w) for w in waves], np.int32)
            batch["audio"] = audio
            batch["audio_padding_mask"] = np.arange(audio.shape[1])[None, :] >= lengths[:, None]
            batch["audio_lengths"] = lengths
            batch["src_text"] = batch["src_tokens"]
            batch["src_text_lengths"] = batch["src_lengths"]
        return batch
