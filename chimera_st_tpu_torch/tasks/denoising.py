"""BART denoising pre-training (counterpart of
chimera_st_tpu/tasks/denoising.py; fairseq ``tasks/denoising.py`` and
``tasks/multilingual_denoising.py``): token blocks of a binarized corpus
(``TokenBlockDataset``, ``--tokens-per-sample`` less bos and eos) noised
by ``DenoisingDataset`` and reconstructed by a seq2seq model (BART) under
the label-smoothed cross entropy.

- ``denoising``: ``dict.txt`` and ``{split}.bin/idx``; the dictionary gains
  ``<mask>``. The noise flags: ``--mask``, ``--mask-random``, ``--insert``,
  ``--rotate``, ``--permute-sentences``, ``--poisson-lambda``,
  ``--replace-length``; ``.`` marks a sentence's end where the dictionary
  has it.
- ``multilingual_denoising`` (mBART): one corpus a language subdirectory
  (``--langs``, or every subdirectory with data), each item suffixed with
  its ``[lang]`` tag (``--add-lang-token``, default on: the tags are added
  before ``<mask>``, as fairseq orders them), and on the train split the
  languages resampled each epoch with probabilities (n_l / N)^alpha
  (``--multilang-sampling-alpha``).

The noise is keyed by ``seed`` of the task's config, which the train CLI
never sets from ``--seed`` (its declared flags do not reach the task): seed
1 in both packages (ROADMAP C).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from ..config.registry import register_task
from ..data.denoising_dataset import DenoisingDataset
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.token_block_dataset import TokenBlockDataset
from ..data.wrappers import IdStampedConcat, ResamplingDataset
from .base import ChimeraTask
from .translation import collate_pairs
from .translation_extra import smoothed_ratios


def denoise_kwargs(cfg: Dict) -> Dict:
    return dict(
        mask=float(cfg.get("mask", 0.3)),
        mask_random=float(cfg.get("mask_random", 0.1)),
        insert=float(cfg.get("insert", 0.0)),
        rotate=float(cfg.get("rotate", 0.0)),
        permute_sentence_ratio=float(cfg.get("permute_sentences", 0.0)),
        poisson_lambda=float(cfg.get("poisson_lambda", 3.5)),
        replace_length=int(cfg.get("replace_length", 1)),
        seed=int(cfg.get("seed", 1)),
    )


@register_task("denoising")
class DenoisingTask(ChimeraTask):
    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.mask_idx = dictionary.add_symbol("<mask>")

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        return cls(cfg, cls.load_dictionary(str(Path(cfg["data"]) / "dict.txt")))

    def _blocks(self, path: str) -> TokenBlockDataset:
        data = MMapIndexedDataset(path)
        return TokenBlockDataset(
            data, data.sizes, int(self.cfg.get("tokens_per_sample", 512)) - 2,
            pad=self.dictionary.pad(), eos=self.dictionary.eos(),
            break_mode=self.cfg.get("sample_break_mode", "complete"))

    def _wrap(self, blocks, append_tokens=None) -> DenoisingDataset:
        d = self.dictionary
        return DenoisingDataset(
            blocks, len(d), self.mask_idx, pad=d.pad(), bos=d.bos(), eos=d.eos(),
            full_stop_idx=d.index(".") if "." in d.indices else None,
            append_tokens=append_tokens, **denoise_kwargs(self.cfg))

    def load_dataset(self, split: str, **kwargs):
        self.datasets[split] = self._wrap(self._blocks(str(Path(self.cfg["data"]) / split)))

    @property
    def source_dictionary(self) -> Dictionary:
        return self.dictionary

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        return collate_pairs(dataset, idx)


@register_task("multilingual_denoising")
class MultilingualDenoisingTask(DenoisingTask):
    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        d = cls.load_dictionary(str(root / "dict.txt"))
        langs = cfg.get("langs")
        if langs:
            langs = [l for l in str(langs).split(",") if l]
        else:
            langs = sorted(p.name for p in root.iterdir()
                           if p.is_dir() and ((p / "dict.txt").exists()
                                              or any(p.glob("train*.idx"))))
        if not langs:
            raise FileNotFoundError(f"no language subdirectories under {root}")
        if bool(cfg.get("add_lang_token", True)):
            for lang in langs:
                d.add_symbol(f"[{lang}]")
        task = cls(cfg, d)
        task.langs = langs
        return task

    def lang_tag_indices(self):
        return {self.dictionary.index(f"[{l}]") for l in self.langs
                if f"[{l}]" in self.dictionary.indices}

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        per_lang, sizes = [], []
        for lang in self.langs:
            blocks = self._blocks(str(root / lang / split))
            tag = None
            if bool(self.cfg.get("add_lang_token", True)):
                tag = np.asarray([self.dictionary.index(f"[{lang}]")], np.int64)
            per_lang.append(self._wrap(blocks, append_tokens=tag))
            sizes.append(len(blocks))
        if split == self.cfg.get("train_subset", "train") and len(per_lang) > 1:
            alpha = float(self.cfg.get("multilang_sampling_alpha", 1.0))
            per_lang = [ResamplingDataset(ds, size_ratio=float(r),
                                          seed=int(self.cfg.get("seed", 1)))
                        for ds, r in zip(per_lang, smoothed_ratios(sizes, alpha))]
        self.datasets[split] = IdStampedConcat(per_lang)
