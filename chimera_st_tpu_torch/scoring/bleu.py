"""BLEU scorers (own copy of chimera_st_tpu/scoring/bleu.py).

- `sacrebleu`: detokenized corpus BLEU through the sacrebleu wheel, which is
  imported only when this scorer is built;
- `bleu`: corpus BLEU over int token ids, its n-grams counted by the C++
  routine ``csrc/libbleu.cpp`` (``ngram_stats_native``: built with g++ on
  first use into ``_build/``; a failed build raises), as the JAX package's
  ``clib`` counts them; ``ngram_stats`` is the Python version it is held
  against.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import host_library
from ..config.registry import register_scorer


@register_scorer("sacrebleu")
class SacrebleuScorer:
    def __init__(self, cfg: Optional[dict] = None, tgt_dict=None):
        import sacrebleu

        self._sb = sacrebleu
        cfg = cfg or {}
        self.tokenizer = cfg.get("sacrebleu_tokenizer", "13a")
        self.lowercase = bool(cfg.get("sacrebleu_lowercase", False))
        self.char_level = bool(cfg.get("sacrebleu_char_level", False))
        self.refs: List[str] = []
        self.hyps: List[str] = []

    def add_string(self, ref: str, pred: str):
        self.refs.append(ref)
        self.hyps.append(pred)

    def corpus_bleu(self):
        return self._sb.corpus_bleu(
            self.hyps,
            [self.refs],
            tokenize="char" if self.char_level else self.tokenizer,
            lowercase=self.lowercase,
        )

    def score(self) -> float:
        return self.corpus_bleu().score

    def result_string(self) -> str:
        return self.corpus_bleu().format()


@dataclass
class BleuStat:
    """n-gram count buckets, summable across workers."""

    reflen: int = 0
    predlen: int = 0
    match1: int = 0
    count1: int = 0
    match2: int = 0
    count2: int = 0
    match3: int = 0
    count3: int = 0
    match4: int = 0
    count4: int = 0

    def __iadd__(self, o: "BleuStat"):
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(o, f))
        return self


def ngram_stats(ref: List[int], pred: List[int]) -> BleuStat:
    """Clipped n-gram matching, n = 1..4 (same counting as libbleu)."""
    s = BleuStat(reflen=len(ref), predlen=len(pred))
    for n in range(1, 5):
        rgrams = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
        pgrams = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
        match = sum(min(c, rgrams[g]) for g, c in pgrams.items())
        count = max(len(pred) - n + 1, 0)
        setattr(s, f"match{n}", match)
        setattr(s, f"count{n}", count)
    return s


def bleu_from_stats(stat: BleuStat, order: int = 4) -> float:
    if stat.count1 == 0:
        return 0.0
    psum = 0.0
    for n in range(1, order + 1):
        m, c = getattr(stat, f"match{n}"), getattr(stat, f"count{n}")
        if c == 0 or m == 0:
            return 0.0
        psum += math.log(m / c)
    bp = min(1.0, math.exp(1 - stat.reflen / max(stat.predlen, 1)))
    return 100.0 * bp * math.exp(psum / order)


class _BleuStatC(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int64) for name in BleuStat.__dataclass_fields__]


def ngram_stats_native(ref: List[int], pred: List[int]) -> BleuStat:
    """``ngram_stats`` counted by the C++ routine."""
    r = np.ascontiguousarray(ref, np.int32)
    p = np.ascontiguousarray(pred, np.int32)
    stat = _BleuStatC()
    host_library.libbleu().chimera_bleu_add(ctypes.addressof(stat), r.ctypes.data, len(r),
                                            p.ctypes.data, len(p))
    return BleuStat(**{f: getattr(stat, f) for f, _ in _BleuStatC._fields_})


@register_scorer("bleu")
class Scorer:
    """Token-id corpus BLEU (n-grams counted by ``ngram_stats_native``)."""

    def __init__(self, cfg: Optional[dict] = None, tgt_dict=None):
        cfg = cfg or {}
        self.pad = int(cfg.get("pad", 1))
        self.eos = int(cfg.get("eos", 2))
        self.unk = int(cfg.get("unk", 3))
        self.stat = BleuStat()

    def reset(self):
        self.stat = BleuStat()

    def add(self, ref, pred):
        ref = [int(t) for t in ref if int(t) != self.pad and int(t) != self.eos]
        pred = [int(t) for t in pred if int(t) != self.pad and int(t) != self.eos]
        # a hypothesis <unk> must never match a reference <unk>
        ref = [-(t + 100) if t == self.unk else t for t in ref]
        self.stat += ngram_stats_native(ref, pred)

    def score(self, order: int = 4) -> float:
        return bleu_from_stats(self.stat, order)

    def result_string(self, order: int = 4) -> str:
        stat = self.stat
        precisions = "/".join(
            f"{100.0 * getattr(stat, f'match{n}') / max(getattr(stat, f'count{n}'), 1):.1f}"
            for n in range(1, order + 1)
        )
        ratio = self.stat.predlen / max(self.stat.reflen, 1)
        return (
            f"BLEU{order} = {self.score(order):.2f}, {precisions} "
            f"(BP={min(1.0, math.exp(1 - self.stat.reflen / max(self.stat.predlen, 1))):.3f}, "
            f"ratio={ratio:.3f}, syslen={self.stat.predlen}, reflen={self.stat.reflen})"
        )
