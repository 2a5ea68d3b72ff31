"""Synthetic benchmark tasks (counterpart of chimera_st_tpu/tasks/dummy.py;
fairseq ``benchmark/dummy_mt.py``, ``dummy_lm.py``, ``dummy_masked_lm.py``):
one fixed example replayed ``--dataset-size`` times, so a run measures the
train step without a data pipeline. The batches are array-equal to the JAX
tasks'.

- ``dummy_mt``: source and target of ``--src-len`` / ``--tgt-len`` ids
  counting up from the first real symbol, the target ending in eos;
- ``dummy_lm``: ``--tokens-per-sample`` + 1 such ids as input and
  next-token target;
- ``dummy_masked_lm``: every 15th position masked (``<mask>``), the target
  the original id there and pad elsewhere.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from ..config.registry import register_task
from ..data.dictionary import Dictionary
from .base import ChimeraTask

logger = logging.getLogger(__name__)


def synthetic_dictionary(vocab: int) -> Dictionary:
    d = Dictionary()
    for i in range(vocab - d.nspecial):
        d.add_symbol(f"w{i}")
    return d


class FixedBatchDataset:
    """A dataset of ``n`` copies of one example."""

    def __init__(self, example: Dict[str, np.ndarray], n: int):
        self.example, self.n = example, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.example

    def num_tokens(self, i):
        return len(self.example["target"])

    def collater(self, samples, *args, **kwargs):
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        batch["nsentences"] = len(samples)
        batch["ntokens"] = float(sum(len(s["target"]) for s in samples))
        return batch


def _counting(d: Dictionary, n: int) -> np.ndarray:
    lo = d.nspecial
    return (np.arange(n, dtype=np.int32) % (len(d) - lo)) + lo


class _DummyTask(ChimeraTask):
    DICT_SIZE = 49996

    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg)
        self.dict = dictionary

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        return cls(cfg, synthetic_dictionary(int(cfg.get("dict_size", cls.DICT_SIZE))))

    def _fixed(self, split: str, example: Dict[str, np.ndarray]) -> None:
        self.datasets[split] = FixedBatchDataset(example, int(self.cfg.get("dataset_size",
                                                                           10000)))

    @property
    def target_dictionary(self):
        return self.dict


@register_task("dummy_mt")
class DummyMTTask(_DummyTask):
    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg, dictionary)
        self.src_len = int(cfg.get("src_len", 30))
        self.tgt_len = int(cfg.get("tgt_len", 30))
        logger.info(f"dummy_mt: dict {len(dictionary)}, src/tgt len "
                    f"{self.src_len}/{self.tgt_len}")

    def load_dataset(self, split: str, **kwargs):
        tgt = _counting(self.dict, self.tgt_len)
        tgt[-1] = self.dict.eos()
        prev = np.concatenate([[self.dict.eos()], tgt[:-1]]).astype(np.int32)
        self._fixed(split, {"src_tokens": _counting(self.dict, self.src_len),
                            "prev_output_tokens": prev, "target": tgt})

    @property
    def source_dictionary(self):
        return self.dict


@register_task("dummy_lm")
class DummyLMTask(_DummyTask):
    def load_dataset(self, split: str, **kwargs):
        seq = _counting(self.dict, int(self.cfg.get("tokens_per_sample", 512)) + 1)
        self._fixed(split, {"net_tokens": seq[:-1], "target": seq[1:]})


@register_task("dummy_masked_lm")
class DummyMaskedLMTask(_DummyTask):
    DICT_SIZE = 49995

    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg, dictionary)
        self.mask_idx = dictionary.add_symbol("<mask>")

    def load_dataset(self, split: str, **kwargs):
        T = int(self.cfg.get("tokens_per_sample", 512))
        seq = _counting(self.dict, T)
        mask = np.arange(T) % 15 == 0
        self._fixed(split, {
            "net_tokens": np.where(mask, self.mask_idx, seq).astype(np.int32),
            "target": np.where(mask, seq, self.dict.pad()).astype(np.int32)})

    @property
    def source_dictionary(self):
        return self.dict
