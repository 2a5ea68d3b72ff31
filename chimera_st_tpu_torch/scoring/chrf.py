"""chrF scorer (own copy of chimera_st_tpu/scoring/chrf.py): sacrebleu's
corpus chrF, the wheel imported when the scorer is built."""

from __future__ import annotations

from typing import List, Optional

from ..config.registry import register_scorer


@register_scorer("chrf")
class ChrFScorer:
    def __init__(self, cfg: Optional[dict] = None, tgt_dict=None):
        import sacrebleu

        self._sb = sacrebleu
        self.refs: List[str] = []
        self.hyps: List[str] = []

    def add_string(self, ref: str, pred: str):
        self.refs.append(ref)
        self.hyps.append(pred)

    def score(self) -> float:
        return self._sb.corpus_chrf(self.hyps, [self.refs]).score

    def result_string(self) -> str:
        return self._sb.corpus_chrf(self.hyps, [self.refs]).format()
