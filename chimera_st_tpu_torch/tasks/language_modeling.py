"""Language modeling task (counterpart of
chimera_st_tpu/tasks/language_modeling.py; reference
fairseq/tasks/language_modeling.py): a monolingual binarized corpus
(``dict.txt``, ``{split}.bin/idx`` from ``chimera-torch-preprocess
--only-source``) cut into token blocks, each an (input, target) pair of the
block shifted right behind eos and the block itself. What ``eval_lm`` reads
and what the train CLI trains a ``transformer_lm*`` on, with the
``lm_cross_entropy`` criterion registered here (or ``cross_entropy``)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config.registry import register_criterion, register_task
from ..data.batching import collate_tokens, round16
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.token_block_dataset import TokenBlockDataset
from .base import ChimeraTask

logger = logging.getLogger(__name__)


class MonolingualDataset:
    """Token blocks as (input, target) LM pairs: the input is the block
    shifted right with eos prepended."""

    def __init__(self, blocks: TokenBlockDataset, pad: int, eos: int):
        self.blocks = blocks
        self.pad = pad
        self.eos = eos

    def __len__(self):
        return len(self.blocks)

    def num_tokens(self, i: int) -> int:
        return self.blocks.num_tokens(i)

    def __getitem__(self, i: int):
        tok = self.blocks[i]
        return {"id": i, "target": tok,
                "source": np.concatenate([[self.eos], tok[:-1]]).astype(np.int32)}

    def collater(self, samples, target_len: Optional[int] = None):
        if not samples:
            return {}
        src = collate_tokens([s["source"] for s in samples], self.pad,
                             target_len=target_len, dtype=np.int32)
        tgt = collate_tokens([s["target"] for s in samples], self.pad,
                             target_len=target_len, dtype=np.int32)
        return {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "net_tokens": src,
            "target": tgt,
            "ntokens": float(sum(len(s["target"]) for s in samples)),
            "nsentences": len(samples),
        }


class ShortenedDataset:
    """Per-document shortening to ``max_len`` tokens before the blocks are
    built (reference fairseq/data/shorten_dataset.py): "truncate" keeps the
    prefix, "random_crop" a window drawn per (seed, epoch, index)."""

    def __init__(self, base, max_len: int, method: str, seed: int = 1):
        if method not in ("truncate", "random_crop"):
            raise ValueError(f"unknown shorten method {method!r}")
        self.base = base
        self.max_len = int(max_len)
        self.method = method
        self.seed = seed
        self.epoch = 1
        self.sizes = np.minimum(np.asarray(base.sizes), self.max_len)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i: int):
        item = self.base[int(i)]
        n = len(item)
        if n <= self.max_len:
            return item
        if self.method == "truncate":
            return item[: self.max_len]
        rng = np.random.default_rng((self.seed, self.epoch, int(i)))
        start = int(rng.integers(0, n - self.max_len + 1))
        return item[start: start + self.max_len]


@register_task("language_modeling")
class LanguageModelingTask(ChimeraTask):
    text_only = True

    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg)
        self.dictionary = dictionary

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        return cls(cfg, cls.load_dictionary(str(Path(cfg["data"]) / "dict.txt")))

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        data = MMapIndexedDataset(str(root / split))
        block = int(self.cfg.get("tokens_per_sample", 512))
        method = self.cfg.get("shorten_method", "none")
        splits = str(self.cfg.get("shorten_data_split_list", "") or "")
        if method != "none" and (not splits or split in splits.split(",")):
            data = ShortenedDataset(data, block, method, seed=int(self.cfg.get("seed", 1)))
        blocks = TokenBlockDataset(data, data.sizes, block, pad=self.dictionary.pad(),
                                   eos=self.dictionary.eos(),
                                   break_mode=self.cfg.get("sample_break_mode", "none"))
        self.datasets[split] = MonolingualDataset(blocks, self.dictionary.pad(),
                                                  self.dictionary.eos())

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len):
        """Inputs and targets padded to a multiple of 16 of the longest
        block (the bucket edge is unused)."""
        samples = [dataset[int(i)] for i in idx]
        return dataset.collater(samples, round16(max(len(s["target"]) for s in samples)))


@register_criterion("lm_cross_entropy")
def make_lm_cross_entropy(cfg: Dict):
    """Next-token cross entropy of a decoder-only LM on ``net_tokens``
    batches, label-smoothed by ``label_smoothing`` (JAX
    ``tasks/language_modeling.py:141-161``); the sample size is the token
    count."""
    from ..criterions.cross_entropy import token_cross_entropy

    return token_cross_entropy(dict(cfg, sentence_avg=False),
                               float(cfg.get("label_smoothing", 0.0)))
