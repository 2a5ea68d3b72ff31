"""Sentence prediction and sentence ranking (counterpart of
chimera_st_tpu/tasks/sentence_prediction.py; fairseq
``tasks/sentence_prediction.py`` and ``tasks/sentence_ranking.py``), the
GLUE-style fine-tunes of BART's classification head. The data layout is
``fairseq-preprocess``'s:

    data/input0/{dict.txt,{split}.idx/bin}    first sentence
    data/input1/...                           optional second sentence
    data/label/{split}.label                  one label a line (text), or
    data/label/dict.txt + binarized labels    class ids

Classification ids come from the train split's sorted labels (text) or the
label dictionary less its specials (binarized); ``--regression-target``
reads floats. A sample is bos, input0 + eos [, input1 + eos], cut to
``--max-positions`` with eos kept last; it is both the source and the
decoder's input, so ``classify`` pools the decoder at its eos positions.
Ranking: ``input0`` the shared context, ``input1..N`` the candidates, one
score each. The port trains these tasks on ``bart*`` models. A
``roberta*`` / ``masked_lm`` model raises: the JAX criterion calls a
``classify`` method that ``MaskedLMModel`` has not, so neither package
trains it (ROADMAP C).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config.registry import register_task
from ..data.batching import collate_tokens, round16
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from .base import ChimeraTask


def _read_labels(path: Path, regression: bool, mapping=None):
    """-> (labels, the label -> id mapping); ``mapping`` pins the ids of
    every split to the train split's."""
    lines = path.read_text().splitlines()
    if regression:
        return np.asarray([float(x) for x in lines], np.float32), None
    if mapping is None:
        label_set = sorted(set(lines))
        mapping = {l: i for i, l in enumerate(label_set)}
    unknown = sorted(set(lines) - set(mapping))
    if unknown:
        raise ValueError(
            f"{path} contains labels absent from the train mapping: {unknown}"
        )
    return np.asarray([mapping[x] for x in lines], np.int64), mapping


def _bart_only(cfg: Dict, dictionary: Dictionary) -> Dict:
    """The vocabulary sizes of the shared dictionary; a model other than
    BART raises (on a masked LM the JAX criterion fails: ROADMAP C)."""
    from ..config.registry import ARCHITECTURES

    arch = cfg.get("arch") or cfg.get("_name")
    model = ARCHITECTURES.get(arch)[0] if arch in ARCHITECTURES else arch
    if model != "bart":
        raise NotImplementedError(
            f"sentence prediction on {arch}: the port trains it on bart* models; on a masked "
            "LM the JAX criterion calls a classify method MaskedLMModel has not, so neither "
            "package trains it (ROADMAP C)")
    out = dict(cfg)
    out.setdefault("vocab_size", len(dictionary))
    out.setdefault("src_vocab_size", len(dictionary))
    out.setdefault("tgt_vocab_size", len(dictionary))
    return out


class _SentencePairs:
    """(input0 [+ sep + input1], label) samples with a seq2seq-style collater
    (src doubles as prev_output so BART's eos-pooled classify head works)."""

    def __init__(self, inputs: List, labels: np.ndarray, dictionary: Dictionary,
                 max_positions: int = 512):
        self.inputs = inputs  # list of MMapIndexedDataset (1 or 2)
        self.labels = labels
        self.d = dictionary
        self.max_positions = max_positions

    def __len__(self):
        return len(self.inputs[0])

    def num_tokens(self, i: int) -> int:
        return sum(len(ds[i]) for ds in self.inputs) + 2

    def __getitem__(self, i: int) -> Dict:
        parts = [np.array([self.d.bos()], np.int64)]
        for j, ds in enumerate(self.inputs):
            toks = np.asarray(ds[i], np.int64)
            if toks[-1] != self.d.eos():
                toks = np.concatenate([toks, [self.d.eos()]])
            parts.append(toks)
        tokens = np.concatenate(parts)[: self.max_positions]
        if tokens[-1] != self.d.eos():
            tokens[-1] = self.d.eos()
        return {"id": i, "tokens": tokens, "label": self.labels[i]}

    def collater(self, samples: List[Dict], target_len: Optional[int] = None):
        if not samples:
            return {}
        src = collate_tokens([s["tokens"] for s in samples], self.d.pad(),
                             target_len=target_len, dtype=np.int32)
        labels = np.asarray([s["label"] for s in samples])
        return {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "src_tokens": src,
            "prev_output_tokens": src,
            "target_labels": labels,
            "ntokens": float(sum(len(s["tokens"]) for s in samples)),
            "nsentences": len(samples),
        }


@register_task("sentence_prediction")
class SentencePredictionTask(ChimeraTask):

    def __init__(self, cfg: Dict, dictionary: Dictionary, num_classes: int):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.num_classes = num_classes

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        d = cls.load_dictionary(str(root / "input0" / "dict.txt"))
        num_classes = int(cfg.get("num_classes", 0))
        mapping = None
        if not cfg.get("regression_target"):
            label_dir = root / "label"
            if (label_dir / "dict.txt").exists():
                # binarized labels: the label dictionary less its specials
                ldict = cls.load_dictionary(str(label_dir / "dict.txt"))
                num_classes = num_classes or (len(ldict) - ldict.nspecial)
            else:
                # text labels: the train split's mapping, for every split
                train_subset = str(cfg.get("train_subset", "train"))
                train_labels = label_dir / f"{train_subset}.label"
                if train_labels.exists():
                    _, mapping = _read_labels(train_labels, False)
                    num_classes = num_classes or len(mapping)
        task = cls(cfg, d, max(num_classes, 1))
        task.label_mapping = mapping
        return task

    def model_config_overrides(self, cfg: Dict) -> Dict:
        out = _bart_only(cfg, self.dictionary)
        out["num_classes"] = 1 if self.cfg.get("regression_target") else self.num_classes
        return out

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        inputs = [MMapIndexedDataset(str(root / "input0" / split))]
        if (root / "input1" / f"{split}.idx").exists():
            inputs.append(MMapIndexedDataset(str(root / "input1" / split)))
        label_dir = root / "label"
        if (label_dir / f"{split}.idx").exists():
            # one label token a row, less the label dictionary's specials
            ldict = self.load_dictionary(str(label_dir / "dict.txt"))
            lds = MMapIndexedDataset(str(label_dir / split))
            labels = np.asarray(
                [int(np.asarray(lds[i])[0]) - ldict.nspecial
                 for i in range(len(lds))], np.int64)
            if bool(self.cfg.get("regression_target", False)):
                raise ValueError(
                    "regression targets must use the text label layout "
                    "(label/{split}.label)")
        else:
            mapping = getattr(self, "label_mapping", None)
            if mapping is None and not self.cfg.get("regression_target"):
                raise FileNotFoundError(
                    f"no canonical label mapping: expected "
                    f"{label_dir}/{self.cfg.get('train_subset', 'train')}"
                    f".label (text layout) or {label_dir}/dict.txt + "
                    f"{split}.bin/idx (binarized layout)")
            labels, _ = _read_labels(
                label_dir / f"{split}.label",
                bool(self.cfg.get("regression_target", False)),
                mapping=mapping,
            )
        self.datasets[split] = _SentencePairs(
            inputs, labels, self.dictionary,
            max_positions=int(self.cfg.get("max_positions", 512)),
        )

    @property
    def source_dictionary(self) -> Dictionary:
        return self.dictionary

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        samples = [dataset[int(i)] for i in idx]
        tl = round16(max(len(s["tokens"]) for s in samples))
        return dataset.collater(samples, tl)


class _RankingCandidates:
    """Shared context + N candidates; batch carries [B, N, T] tokens."""

    def __init__(self, context, candidates: List, labels: np.ndarray,
                 dictionary: Dictionary, max_positions: int = 512):
        self.context = context
        self.candidates = candidates
        self.labels = labels
        self.d = dictionary
        self.max_positions = max_positions

    def __len__(self):
        return len(self.candidates[0])

    def num_tokens(self, i: int) -> int:
        ctx = len(self.context[i]) if self.context is not None else 0
        return max(ctx + len(c[i]) + 2 for c in self.candidates)

    def _join(self, i: int, cand) -> np.ndarray:
        parts = [np.array([self.d.bos()], np.int64)]
        if self.context is not None:
            ctx = np.asarray(self.context[i], np.int64)
            if ctx[-1] != self.d.eos():
                ctx = np.concatenate([ctx, [self.d.eos()]])
            parts.append(ctx)
        toks = np.asarray(cand[i], np.int64)
        if toks[-1] != self.d.eos():
            toks = np.concatenate([toks, [self.d.eos()]])
        parts.append(toks)
        out = np.concatenate(parts)[: self.max_positions]
        if out[-1] != self.d.eos():
            out[-1] = self.d.eos()
        return out

    def __getitem__(self, i: int) -> Dict:
        return {
            "id": i,
            "candidates": [self._join(i, c) for c in self.candidates],
            "label": int(self.labels[i]),
        }

    def collater(self, samples: List[Dict], target_len: Optional[int] = None):
        if not samples:
            return {}
        N = len(samples[0]["candidates"])
        per_cand = [
            collate_tokens([s["candidates"][n] for s in samples], self.d.pad(),
                           target_len=target_len, dtype=np.int32)
            for n in range(N)
        ]
        return {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "candidate_tokens": np.stack(per_cand, axis=1),  # [B, N, T]
            "target_labels": np.asarray([s["label"] for s in samples], np.int64),
            "ntokens": float(sum(
                sum(len(c) for c in s["candidates"]) for s in samples
            )),
            "nsentences": len(samples),
        }


@register_task("sentence_ranking")
class SentenceRankingTask(ChimeraTask):

    def __init__(self, cfg: Dict, dictionary: Dictionary, num_candidates: int):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.num_candidates = num_candidates

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        d = cls.load_dictionary(str(root / "input0" / "dict.txt"))
        n = int(cfg.get("num_candidates", 0))
        if not n:
            n = len(sorted(root.glob("input[1-9]*"))) or 2
        return cls(cfg, d, n)

    def model_config_overrides(self, cfg: Dict) -> Dict:
        out = _bart_only(cfg, self.dictionary)
        out["num_classes"] = 1  # one ranking score a candidate
        return out

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        context = None
        if (root / "input0" / f"{split}.idx").exists():
            context = MMapIndexedDataset(str(root / "input0" / split))
        candidates = [
            MMapIndexedDataset(str(root / f"input{n}" / split))
            for n in range(1, self.num_candidates + 1)
        ]
        labels, _ = _read_labels(root / "label" / f"{split}.label", True)
        self.datasets[split] = _RankingCandidates(
            context, candidates, labels.astype(np.int64), self.dictionary,
            max_positions=int(self.cfg.get("max_positions", 512)),
        )

    @property
    def source_dictionary(self) -> Dictionary:
        return self.dictionary

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        samples = [dataset[int(i)] for i in idx]
        tl = round16(max(max(len(c) for c in s["candidates"]) for s in samples))
        return dataset.collater(samples, tl)


