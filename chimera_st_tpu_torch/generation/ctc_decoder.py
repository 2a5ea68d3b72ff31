"""CTC prefix beam search with optional n-gram LM shallow fusion (own copy of
chimera_st_tpu/generation/ctc_decoder.py), on the host in numpy.

Replaces the reference's wav2letter (flashlight) KenLM decoders used by the
CTC criterion's WER scoring (reference: fairseq/criterions/ctc_chi.py
W2lKenLMDecoder / W2lViterbiDecoder). Host-side, like the reference's CPU
decoders: runs over per-utterance log-probs during validation.

- `ArpaLM`: reads an ARPA-format back-off n-gram model (the text format
  KenLM trains; no kenlm wheel needed) and scores token continuations.
- `ctc_beam_search`: standard prefix beam search tracking (p_blank,
  p_non_blank) per prefix, with LM fusion on token emission
  (lexicon-free decoding — the reference's --w2l-decoder lexicon-free path).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LOG0 = -1e30


def _logadd(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b <= LOG0:
        return a
    return a + math.log1p(math.exp(b - a))


class ArpaLM:
    """Back-off n-gram LM from an ARPA text file.

    Scores are natural-log (ARPA stores log10). Unknown tokens fall back
    through back-off weights, ending at <unk> or a floor."""

    def __init__(self, path: str):
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []
        order = 0
        section = 0
        ln10 = math.log(10.0)
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\") and "-grams:" in line:
                    section = int(line.split("-")[0].lstrip("\\"))
                    while len(self.ngrams) < section:
                        self.ngrams.append({})
                    continue
                if line.startswith("\\") or line.startswith("ngram") or line == "\\data\\":
                    continue
                if line == "\\end\\":
                    break
                if section == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < section + 1:
                        continue
                    prob = float(parts[0])
                    toks = tuple(parts[1 : 1 + section])
                    back = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
                else:
                    prob = float(parts[0])
                    toks = tuple(parts[1].split())
                    back = float(parts[2]) if len(parts) > 2 else 0.0
                self.ngrams[section - 1][toks] = (prob * ln10, back * ln10)
        self.order = len(self.ngrams)

    def score(self, context: Sequence[str], token: str) -> float:
        """log p(token | context) with back-off."""
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        while True:
            entry = self.ngrams[len(ctx)].get(ctx + (token,)) if len(ctx) < self.order else None
            if entry is not None:
                return entry[0]
            if not ctx:
                uni = self.ngrams[0].get((token,))
                if uni is not None:
                    return uni[0]
                unk = self.ngrams[0].get(("<unk>",))
                return unk[0] if unk is not None else -20.0
            back = self.ngrams[len(ctx) - 1].get(ctx)
            backoff = back[1] if back is not None else 0.0
            ctx = ctx[1:]
            # accumulate back-off weight by recursing with shorter context
            return backoff + self.score(ctx, token)


def ctc_beam_search(
    log_probs: np.ndarray,  # [T, V] per-frame log-probs
    beam_size: int = 10,
    blank: int = 0,
    lm: Optional[ArpaLM] = None,
    lm_weight: float = 1.0,
    token_strings: Optional[Sequence[str]] = None,  # vocab id -> LM token
    word_score: float = 0.0,  # per-emission bonus (reference --word-score)
) -> List[Tuple[List[int], float]]:
    """Prefix beam search; returns [(token ids, log score)] best-first."""
    T, V = log_probs.shape
    # beams: prefix tuple -> (log p ending in blank, log p ending in non-blank)
    beams: Dict[Tuple[int, ...], Tuple[float, float]] = {(): (0.0, LOG0)}
    topk = min(beam_size * 4, V)

    # hoisted out of the per-(frame x beam x candidate) inner loop: building
    # the V-element name list (and the prefix context) per call dominated
    # host-side decode cost
    names = token_strings if lm is not None and token_strings is not None \
        else ([str(i) for i in range(V)] if lm is not None else None)
    ctx_cache: Dict[Tuple[int, ...], List[str]] = {}

    def lm_score(prefix: Tuple[int, ...], tok: int) -> float:
        if lm is None:
            return 0.0
        ctx = ctx_cache.get(prefix)
        if ctx is None:
            ctx = [names[t] for t in prefix]
            ctx_cache[prefix] = ctx
        return lm_weight * lm.score(ctx, names[tok]) + word_score

    for t in range(T):
        ctx_cache.clear()  # only this frame's beam prefixes recur
        frame = log_probs[t]
        cand = np.argpartition(-frame, topk - 1)[:topk]
        if blank not in cand:
            # the blank transition must stay available every frame even when
            # it falls outside the top-k — dropping it kills the
            # after-blank-new-copy path for repeated symbols
            cand = np.append(cand, blank)
        new: Dict[Tuple[int, ...], List[float]] = defaultdict(lambda: [LOG0, LOG0])
        for prefix, (pb, pnb) in beams.items():
            p_tot = _logadd(pb, pnb)
            for v in cand:
                p = float(frame[v])
                if v == blank:
                    e = new[prefix]
                    e[0] = _logadd(e[0], p_tot + p)
                    continue
                last = prefix[-1] if prefix else None
                if v == last:
                    # same symbol: extends non-blank stays same prefix;
                    # after a blank it starts a NEW copy of the symbol
                    e = new[prefix]
                    e[1] = _logadd(e[1], pnb + p)
                    e2 = new[prefix + (int(v),)]
                    e2[1] = _logadd(e2[1], pb + p + lm_score(prefix, int(v)))
                else:
                    e2 = new[prefix + (int(v),)]
                    e2[1] = _logadd(
                        e2[1], p_tot + p + lm_score(prefix, int(v))
                    )
        scored = sorted(
            new.items(), key=lambda kv: -_logadd(kv[1][0], kv[1][1])
        )[:beam_size]
        beams = {k: (v[0], v[1]) for k, v in scored}

    out = sorted(
        ((list(p), _logadd(pb, pnb)) for p, (pb, pnb) in beams.items()),
        key=lambda x: -x[1],
    )
    return out
