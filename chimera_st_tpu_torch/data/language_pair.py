"""Parallel text (own copy of chimera_st_tpu/data/language_pair.py): source
and target token arrays, binarized (``MMapIndexedDataset``) or in memory.

The collater sorts the samples by descending source length and emits the
batch the text branch of the model reads: ``src_tokens``, ``src_lengths``,
``prev_output_tokens`` (the target shifted right behind eos), ``target``,
``ntokens`` and ``nsentences``, source and target each padded to its own
``target_len``."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .batching import collate_tokens
from .dictionary import Dictionary


class LanguagePairDataset:
    def __init__(self, src, tgt, src_dict: Dictionary, tgt_dict: Optional[Dictionary] = None):
        self.src = src
        self.tgt = tgt
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict or src_dict
        self.src_sizes = np.asarray(getattr(src, "sizes", [len(s) for s in src]), np.int64)
        self.tgt_sizes = np.asarray(getattr(tgt, "sizes", [len(t) for t in tgt]), np.int64)

    def __len__(self):
        return len(self.src_sizes)

    def num_tokens(self, i: int) -> int:
        return int(max(self.src_sizes[i], self.tgt_sizes[i]))

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return {"id": i, "source": np.asarray(self.src[i], np.int32),
                "target": np.asarray(self.tgt[i], np.int32)}

    def collater(self, samples: List[Dict], src_target_len: Optional[int] = None,
                 tgt_target_len: Optional[int] = None) -> Dict[str, Any]:
        if not samples:
            return {}
        samples = sorted(samples, key=lambda s: -len(s["source"]))
        pad, eos = self.tgt_dict.pad(), self.tgt_dict.eos()
        src = collate_tokens([s["source"] for s in samples], self.src_dict.pad(),
                             target_len=src_target_len, dtype=np.int32)
        tgt = collate_tokens([s["target"] for s in samples], pad, target_len=tgt_target_len,
                             dtype=np.int32)
        prev = collate_tokens([np.concatenate([[eos], s["target"][:-1]]) for s in samples], pad,
                              target_len=tgt_target_len, dtype=np.int32)
        return {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "src_tokens": src,
            "src_lengths": np.asarray([len(s["source"]) for s in samples], np.int32),
            "prev_output_tokens": prev,
            "target": tgt,
            "ntokens": float(sum(len(s["target"]) for s in samples)),
            "nsentences": len(samples),
        }
