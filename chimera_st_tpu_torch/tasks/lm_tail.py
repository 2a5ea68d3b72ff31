"""Cross-lingual and legacy masked LMs and the tutorial classification task
(counterpart of chimera_st_tpu/tasks/lm_tail.py).

- ``cross_lingual_lm`` / ``multilingual_masked_lm`` (fairseq
  ``tasks/cross_lingual_lm.py``, ``tasks/multilingual_masked_lm.py``): the
  masked LM over one binarized folder a language (``--monolingual-langs`` /
  ``--langs``, else every folder with a train split), each item stamped
  with its language id; on the train split the languages are resampled
  each epoch with probabilities (n_i / N)^``--multilang-sampling-alpha``.
- ``legacy_masked_lm`` (fairseq ``tasks/legacy_masked_lm.py``): BERT's
  objective over sentence pairs, ``<s> A <sep> B </s>`` with B the next
  sentence or, half the time, a random one; the dictionary gains ``<mask>``
  and ``<sep>``. Its criterion (``legacy_masked_lm``, also registered as
  ``legacy_masked_lm_loss``) adds the next-sentence cross entropy of
  ``forward_with_sentence`` (one encoder pass) to the masked-LM loss where
  the model has the head.
- ``simple_classification`` (fairseq's tutorial
  ``tasks/simple_classification.py``): ``{split}.input`` lines of words and
  ``{split}.label`` lines of labels over ``dict.input.txt`` /
  ``dict.label.txt``, each input closed by eos and a batch padded to a
  multiple of 16; its criterion is the summed cross entropy of the model's
  class log-probabilities (``rnn_classifier``), over the sentence count.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.registry import register_criterion, register_task
from ..criterions.masked_lm import apply_bert_masking, masked_nll
from ..data.batching import collate_tokens, round16
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.wrappers import IdStampedConcat, ResamplingDataset
from .base import ChimeraTask
from .masked_lm import MaskedTokensDataset, collate_masked, masked_blocks
from .translation_extra import smoothed_ratios

logger = logging.getLogger(__name__)


def _lang_dirs(root: Path, langs_cfg) -> List[str]:
    if langs_cfg:
        return [l.strip() for l in str(langs_cfg).split(",") if l.strip()]
    langs = sorted(p.name for p in root.iterdir() if p.is_dir() and any(p.glob("train*.idx")))
    if not langs:
        raise FileNotFoundError(f"no language subdirectories under {root}")
    return langs


class _LangTaggedMasked:
    """A ``MaskedTokensDataset`` whose items carry a constant language id.
    It has no ``set_epoch``, as in JAX: the masks of a language that is not
    resampled keep epoch 1's draws (ROADMAP C)."""

    def __init__(self, base: MaskedTokensDataset, lang_id: int):
        self.base = base
        self.lang_id = lang_id

    def __len__(self):
        return len(self.base)

    def num_tokens(self, i):
        return self.base.num_tokens(i)

    def __getitem__(self, i):
        item = dict(self.base[i])
        item["lang_id"] = self.lang_id
        return item

    def collater(self, samples, target_len=None):
        batch = self.base.collater(samples, target_len=target_len)
        batch["lang_ids"] = np.asarray([s.get("lang_id", 0) for s in samples], np.int32)
        return batch


@register_task("cross_lingual_lm")
@register_task("multilingual_masked_lm")
class CrossLingualLMTask(ChimeraTask):
    def __init__(self, cfg: Dict, dictionary: Dictionary, langs: List[str]):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.langs = langs
        self.langs2id = {l: i for i, l in enumerate(langs)}
        self.mask_idx = dictionary.add_symbol("<mask>")

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        d = cls.load_dictionary(str(root / "dict.txt"))
        langs = _lang_dirs(root, cfg.get("monolingual_langs") or cfg.get("langs"))
        logger.info(f"cross-lingual LM over {langs}")
        return cls(cfg, d, langs)

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        parts, sizes = [], []
        for lang in self.langs:
            masked = masked_blocks(self.cfg, self.dictionary, self.mask_idx,
                                   str(root / lang / split))
            parts.append(_LangTaggedMasked(masked, self.langs2id[lang]))
            sizes.append(len(masked))
        if split == self.cfg.get("train_subset", "train") and len(parts) > 1:
            alpha = float(self.cfg.get("multilang_sampling_alpha", 1.0))
            parts = [ResamplingDataset(p, size_ratio=float(r), seed=int(self.cfg.get("seed", 1)))
                     for p, r in zip(parts, smoothed_ratios(sizes, alpha))]
        self.datasets[split] = IdStampedConcat(parts)

    @property
    def source_dictionary(self) -> Dictionary:
        return self.dictionary

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        return collate_masked(dataset, idx)


# --------------------------------------------------------- legacy masked LM


class _SentencePairBlocks:
    """(sentence A, sentence B, is-next) samples with BERT masking; the
    framing bos / sep / eos is never masked and never a target."""

    def __init__(self, sentences: List[np.ndarray], dictionary: Dictionary, mask_idx: int,
                 sep_idx: int, mask_prob: float = 0.15, seed: int = 1):
        self.sentences = sentences
        self.d = dictionary
        self.mask_idx = mask_idx
        self.sep_idx = sep_idx
        self.mask_prob = mask_prob
        self.seed = seed

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.sentences)

    def num_tokens(self, i):
        j = (i + 1) % len(self.sentences)
        return len(self.sentences[i]) + len(self.sentences[j]) + 3

    def __getitem__(self, i):
        rng = np.random.default_rng([self.seed, getattr(self, "epoch", 1), i])
        a = self.sentences[i]
        is_next = bool(rng.random() < 0.5)
        if is_next:
            b = self.sentences[(i + 1) % len(self.sentences)]
        else:
            b = self.sentences[int(rng.integers(len(self.sentences)))]
        tokens = np.concatenate([[self.d.bos()], a, [self.sep_idx], b,
                                 [self.d.eos()]]).astype(np.int64)
        segments = np.concatenate([np.zeros(len(a) + 2, np.int32), np.ones(len(b) + 1, np.int32)])
        net, target = apply_bert_masking(tokens, self.mask_idx, len(self.d),
                                         mask_prob=self.mask_prob, rng=rng, nspecial=4)
        frame = np.array([0, len(a) + 1, len(tokens) - 1])
        net[frame] = tokens[frame]
        target[frame] = self.d.pad()
        return {"id": i, "net_tokens": net, "target": target, "segments": segments,
                "sentence_target": int(is_next)}

    def collater(self, samples, target_len: Optional[int] = None):
        if not samples:
            return {}
        pad = self.d.pad()

        def col(key, value):
            return collate_tokens([s[key] for s in samples], value, target_len=target_len,
                                  dtype=np.int32)

        return {"id": np.asarray([s["id"] for s in samples], np.int64),
                "net_tokens": col("net_tokens", pad), "target": col("target", pad),
                "segments": col("segments", 0),
                "sentence_target": np.asarray([s["sentence_target"] for s in samples], np.int64),
                "ntokens": float(sum(len(s["target"]) for s in samples)),
                "nsentences": len(samples)}


@register_task("legacy_masked_lm")
class LegacyMaskedLMTask(ChimeraTask):
    def __init__(self, cfg: Dict, dictionary: Dictionary):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.mask_idx = dictionary.add_symbol("<mask>")
        self.sep_idx = dictionary.add_symbol("<sep>")

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        return cls(cfg, cls.load_dictionary(str(Path(cfg["data"]) / "dict.txt")))

    def load_dataset(self, split: str, **kwargs):
        data = MMapIndexedDataset(str(Path(self.cfg["data"]) / split))
        sentences = [np.asarray(data[i]) for i in range(len(data))]
        self.datasets[split] = _SentencePairBlocks(
            sentences, self.dictionary, self.mask_idx, self.sep_idx,
            mask_prob=float(self.cfg.get("mask_prob", 0.15)), seed=int(self.cfg.get("seed", 1)))

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        return collate_masked(dataset, idx, key="net_tokens")


@register_criterion("legacy_masked_lm_loss")
@register_criterion("legacy_masked_lm")
def make_legacy_masked_lm(cfg: Dict):
    """The masked positions' cross entropy plus ``nsp_loss_weight`` times
    the next-sentence cross entropy (where the model has the head); the
    sample size is the masked count, at least 1."""
    pad = int(cfg.get("padding_idx", 1))
    nsp_weight = float(cfg.get("nsp_loss_weight", 1.0))

    def criterion(model, batch, generator=None, num_updates=None):
        has_nsp = (hasattr(model, "forward_with_sentence")
                   and getattr(model.cfg, "sentence_class_num", 0) > 0)
        if has_nsp:
            logits, sent_logits = model.forward_with_sentence(batch["net_tokens"], generator)
        else:
            logits = model(batch["net_tokens"], generator)
        mlm_loss, keep = masked_nll(logits, batch["target"], pad)
        nsp_loss = torch.zeros((), device=logits.device)
        if has_nsp:
            sl = torch.log_softmax(sent_logits.float(), dim=-1)
            nsp_loss = -sl.gather(-1, batch["sentence_target"].long()[:, None]).sum()
        loss = mlm_loss + nsp_weight * nsp_loss
        sample_size = torch.clamp(keep.sum().float(), min=1.0)
        return loss, sample_size, {"loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss,
                                   "sample_size": sample_size,
                                   "ntokens": batch.get("ntokens", sample_size),
                                   "nsentences": batch["net_tokens"].shape[0]}

    return criterion


# ------------------------------------------------------ simple_classification


class _LabeledText:
    def __init__(self, inputs: List[np.ndarray], labels: np.ndarray, pad: int):
        self.inputs, self.labels, self.pad = inputs, labels, pad

    def __len__(self):
        return len(self.inputs)

    def num_tokens(self, i):
        return len(self.inputs[i])

    def __getitem__(self, i):
        return {"id": i, "tokens": self.inputs[i], "label": int(self.labels[i])}

    def collater(self, samples, target_len: Optional[int] = None):
        if not samples:
            return {}
        return {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "net_tokens": collate_tokens([s["tokens"] for s in samples], self.pad,
                                         target_len=target_len, dtype=np.int32),
            "target_labels": np.asarray([s["label"] for s in samples], np.int64),
            "ntokens": float(sum(len(s["tokens"]) for s in samples)),
            "nsentences": len(samples),
        }


@register_task("simple_classification")
class SimpleClassificationTask(ChimeraTask):
    def __init__(self, cfg: Dict, input_vocab: Dictionary, label_vocab: Dictionary):
        super().__init__(cfg)
        self.input_vocab, self.label_vocab = input_vocab, label_vocab

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        input_vocab = cls.load_dictionary(str(root / "dict.input.txt"))
        label_vocab = cls.load_dictionary(str(root / "dict.label.txt"))
        logger.info(f"[input] {len(input_vocab)} types, [label] {len(label_vocab)} types")
        return cls(cfg, input_vocab, label_vocab)

    def model_config_overrides(self, cfg: Dict) -> Dict:
        out = dict(cfg)
        out.setdefault("vocab_size", len(self.input_vocab))
        out.setdefault("num_classes", len(self.label_vocab))
        return out

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        inputs = [np.asarray(self.input_vocab.encode_line(line, append_eos=True,
                                                          add_if_not_exist=False), np.int64)
                  for line in (root / f"{split}.input").read_text().splitlines()]
        labels = np.asarray([self.label_vocab.index(line.strip())
                             for line in (root / f"{split}.label").read_text().splitlines()])
        self.datasets[split] = _LabeledText(inputs, labels, self.input_vocab.pad())

    @property
    def source_dictionary(self) -> Dictionary:
        return self.input_vocab

    @property
    def target_dictionary(self) -> Dictionary:
        return self.label_vocab

    def collate_indices(self, dataset, idx, target_len=None):
        samples = [dataset[int(i)] for i in idx]
        return dataset.collater(samples, round16(max(len(s["tokens"]) for s in samples)))


@register_criterion("simple_classification")
def make_simple_classification(cfg: Dict):
    """The summed negative log-probability of each sentence's label, over
    the sentence count; ``ncorrect`` counts the argmax hits."""

    def criterion(model, batch, generator=None, num_updates=None):
        lp = model(batch["net_tokens"], generator)  # [B, C] log-probs
        targets = batch["target_labels"]
        loss = -lp.gather(-1, targets.long()[:, None]).sum()
        ncorrect = (lp.argmax(dim=-1) == targets).float().sum()
        n = float(targets.shape[0])
        return loss, n, {"loss": loss, "ncorrect": ncorrect, "sample_size": n,
                         "ntokens": batch.get("ntokens", n), "nsentences": targets.shape[0]}

    return criterion
