"""Attention-aligned unknown-word replacement (own copy of
chimera_st_tpu/generation/unk_replace.py, the ``--replace-unk`` path): each
``<unk>`` of a hypothesis becomes the source word its cross-attention argmax
points at, mapped through an optional alignment dictionary ("src_word
tgt_word" per line), else copied."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


def load_align_dict(path: Optional[str]) -> Dict[str, str]:
    """The ``src tgt`` pairs of a fairseq alignment dictionary; no path (or
    ``--replace-unk`` without one) gives an empty table: pure copying."""
    table: Dict[str, str] = {}
    if not path or path is True:
        return table
    with open(path, encoding="utf-8") as f:
        for line in f:
            cols = line.split()
            if len(cols) >= 2:
                table[cols[0]] = cols[1]
    return table


def replace_unk_tokens(hyp_symbols: List[str], src_words: Sequence[str],
                       alignment: Sequence[int], align_dict: Dict[str, str],
                       unk_symbol: str) -> List[str]:
    """Each ``unk_symbol`` in ``hyp_symbols`` replaced by the source word at
    ``alignment[t]`` (the source position target position t attends to
    most), clamped to the last source word."""
    out = []
    for t, sym in enumerate(hyp_symbols):
        if sym == unk_symbol and len(src_words):
            idx = min(int(alignment[t]) if t < len(alignment) else 0, len(src_words) - 1)
            src_word = src_words[idx]
            out.append(align_dict.get(src_word, src_word))
        else:
            out.append(sym)
    return out
