"""Masked-LM pre-training (counterpart of chimera_st_tpu/tasks/masked_lm.py;
fairseq ``tasks/masked_lm.py``): token blocks of a binarized corpus
(``--tokens-per-sample``, ``--sample-break-mode``) with BERT masking drawn
per item from (seed, epoch, index), so the masks re-roll every epoch and a
resume replays them. The dictionary gains ``<mask>``; a batch's rows are
padded to a multiple of 16 (``round16``), as in JAX."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config.registry import register_task
from ..criterions.masked_lm import apply_bert_masking
from ..data.batching import collate_tokens, round16
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.token_block_dataset import TokenBlockDataset
from .base import ChimeraTask


class MaskedTokensDataset:
    """BERT masking of each block on access, from the numpy stream of
    (seed, epoch, index)."""

    def __init__(self, blocks, mask_idx: int, vocab_size: int, pad: int = 1,
                 mask_prob: float = 0.15, seed: int = 1, nspecial: int = 4):
        self.blocks = blocks
        self.mask_idx = mask_idx
        self.vocab_size = vocab_size
        self.pad = pad
        self.mask_prob = mask_prob
        self.seed = seed
        self.nspecial = nspecial

    def __len__(self):
        return len(self.blocks)

    def num_tokens(self, i: int) -> int:
        return self.blocks.num_tokens(i)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __getitem__(self, i: int):
        rng = np.random.default_rng([self.seed, getattr(self, "epoch", 1), i])
        net, target = apply_bert_masking(self.blocks[i], self.mask_idx, self.vocab_size,
                                         mask_prob=self.mask_prob, rng=rng,
                                         nspecial=self.nspecial)
        return {"id": i, "net_tokens": net, "target": target}

    def collater(self, samples, target_len: Optional[int] = None):
        if not samples:
            return {}
        net = collate_tokens([s["net_tokens"] for s in samples], self.pad,
                             target_len=target_len, dtype=np.int32)
        tgt = collate_tokens([s["target"] for s in samples], self.pad,
                             target_len=target_len, dtype=np.int32)
        return {"id": np.asarray([s["id"] for s in samples], np.int64), "net_tokens": net,
                "target": tgt, "ntokens": float((tgt != self.pad).sum()),
                "nsentences": len(samples)}


def masked_blocks(cfg: Dict, dictionary: Dictionary, mask_idx: int, prefix: str
                  ) -> MaskedTokensDataset:
    """The masked token blocks of the binarized split at ``prefix``."""
    data = MMapIndexedDataset(prefix)
    blocks = TokenBlockDataset(data, data.sizes, int(cfg.get("tokens_per_sample", 512)),
                               pad=dictionary.pad(), eos=dictionary.eos(),
                               break_mode=cfg.get("sample_break_mode", "complete"))
    return MaskedTokensDataset(blocks, mask_idx, len(dictionary), pad=dictionary.pad(),
                               mask_prob=float(cfg.get("mask_prob", 0.15)),
                               seed=int(cfg.get("seed", 1)))


def collate_masked(dataset, idx, key: str = "target"):
    """A batch of ``dataset``'s items ``idx``, padded to the longest
    ``key`` rounded up to 16."""
    samples = [dataset[int(i)] for i in idx]
    return dataset.collater(samples, target_len=round16(max(len(s[key]) for s in samples)))


@register_task("masked_lm")
class MaskedLMTask(ChimeraTask):
    text_only = True

    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.mask_idx = dictionary.add_symbol("<mask>")

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        return cls(cfg, cls.load_dictionary(str(Path(cfg["data"]) / "dict.txt")))

    def load_dataset(self, split: str, **kwargs):
        self.datasets[split] = masked_blocks(self.cfg, self.dictionary, self.mask_idx,
                                             str(Path(self.cfg["data"]) / split))

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        return collate_masked(dataset, idx)
