"""Multilingual translation (counterpart of
chimera_st_tpu/tasks/multilingual_translation.py; fairseq
``tasks/multilingual_translation.py``): one ``multilingual_transformer``
over ``--lang-pairs``, ``dict.{lang}.txt`` a language and
``{split}.{src}-{tgt}.{lang}.bin/idx`` a pair. Every batch holds one pair
(``batch_groups``: the base task packs each pair's samples on their own)
and carries it as ``task_name``, which the train step passes to the
criterion with the batch: ``multilingual_label_smoothed_cross_entropy``
routes it through the pair's encoder and decoder. The dictionaries must
agree in size: the model's tables are sized from one (a joined
dictionary)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config.registry import register_criterion, register_task
from ..criterions.label_smoothed_ce import ce_loss_from_logits
from ..data.batching import round16
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.language_pair import LanguagePairDataset
from ..data.wrappers import ConcatDataset
from .base import ChimeraTask

logger = logging.getLogger(__name__)


class _TaggedDataset:
    """A language-pair dataset whose batches carry their pair."""

    def __init__(self, base, pair: str):
        self.base = base
        self.pair = pair

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        return (self.pair, self.base[int(i)])

    def num_tokens(self, i):
        return self.base.num_tokens(int(i))

    def collater(self, samples, **kwargs):
        batch = self.base.collater([s for _, s in samples], **kwargs)
        batch["task_name"] = samples[0][0]
        return batch


@register_task("multilingual_translation")
class MultilingualTranslationTask(ChimeraTask):
    def __init__(self, cfg: Dict, dicts: Dict[str, Dictionary], pairs):
        super().__init__(cfg)
        self.dicts = dicts
        self.pairs = pairs

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        pairs = cfg.get("lang_pairs")
        pairs = pairs.split(",") if isinstance(pairs, str) else list(pairs)
        langs = sorted({l for p in pairs for l in p.split("-")})
        dicts = {l: cls.load_dictionary(str(root / f"dict.{l}.txt")) for l in langs}
        logger.info(f"multilingual: pairs {pairs}, dicts "
                    + str({l: len(d) for l, d in dicts.items()}))
        return cls(cfg, dicts, pairs)

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        parts = []
        for pair in self.pairs:
            src, tgt = pair.split("-")
            prefix = str(root / f"{split}.{src}-{tgt}.")
            base = LanguagePairDataset(MMapIndexedDataset(prefix + src),
                                       MMapIndexedDataset(prefix + tgt),
                                       self.dicts[src], self.dicts[tgt])
            parts.append(_TaggedDataset(base, pair))
        self.datasets[split] = parts[0] if len(parts) == 1 else ConcatDataset(parts)

    def batch_groups(self, dataset) -> Optional[np.ndarray]:
        """Each sample's pair index, so that no batch mixes pairs."""
        if not isinstance(dataset, ConcatDataset):
            return None
        bounds = np.asarray([0] + list(dataset.cumulative_sizes))
        return np.searchsorted(bounds, np.arange(len(dataset)), side="right") - 1

    def collate_indices(self, dataset, idx, target_len: Optional[int] = None):
        samples = [dataset[int(i)] for i in idx]
        pairs = sorted({s[0] for s in samples})
        if len(pairs) > 1:  # batch_groups keeps a batch to one pair
            raise AssertionError(f"mixed language pairs in one batch: {pairs}")
        src_max = round16(max(len(s["source"]) for _, s in samples))
        tgt_max = round16(max(len(s["target"]) for _, s in samples))
        return dataset.collater(samples, src_target_len=src_max, tgt_target_len=tgt_max)

    def model_config_overrides(self, cfg: Dict) -> Dict:
        cfg = dict(cfg)
        cfg.setdefault("lang_pairs", tuple(self.pairs))
        sizes = {lang: len(d) for lang, d in self.dicts.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(
                "multilingual_translation shares one embedding table across languages but "
                f"the dictionaries differ in size: {sizes}; binarize with --joined-dictionary")
        src, tgt = self.pairs[0].split("-")
        cfg.setdefault("src_vocab_size", len(self.dicts[src]))
        cfg.setdefault("tgt_vocab_size", len(self.dicts[tgt]))
        return cfg

    def build_generator(self, model, gen_cfg, strategy=None):
        raise NotImplementedError(
            "multilingual_transformer has no encode_text / decoder.step: the JAX generator "
            "cannot decode it either, so it is trained and validated only (ROADMAP C)")

    @property
    def source_dictionary(self):
        return self.dicts[self.pairs[0].split("-")[0]]

    @property
    def target_dictionary(self):
        return self.dicts[self.pairs[0].split("-")[1]]


@register_criterion("multilingual_label_smoothed_cross_entropy")
def make_multilingual_ce(cfg: Dict):
    """The label-smoothed cross entropy of a batch through its pair's
    encoder and decoder (the first pair where the batch names none)."""
    eps = float(cfg.get("label_smoothing", 0.1))
    pad = int(cfg.get("padding_idx", 1))
    sentence_avg = bool(cfg.get("sentence_avg", False))

    def criterion(model, batch, generator=None, num_updates=None):
        pair = batch.get("task_name") or model.cfg.lang_pairs[0]
        logits = model.forward_pair(pair, batch["src_tokens"], batch["prev_output_tokens"],
                                    generator)
        loss, nll = ce_loss_from_logits(logits, batch["target"], eps, pad)
        ntokens, nsentences = batch["ntokens"], batch["target"].shape[0]
        sample_size = nsentences if sentence_avg else ntokens
        return loss, sample_size, {"loss": loss, "nll_loss": nll, "ntokens": ntokens,
                                   "nsentences": nsentences, "sample_size": sample_size}

    return criterion
