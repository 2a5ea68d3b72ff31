"""Word error rate (own copy of chimera_st_tpu/scoring/wer.py; fairseq
``scoring/wer.py``): ``letter_words`` (the words of a letter-label
sequence, as the JAX CLIs' CTC decoding and WER validation read them),
``levenshtein`` (the C++ routine ``csrc/libbleu.cpp``
``chimera_levenshtein``, as the JAX package's ``libnat.levenshtein``, built
with g++ on first use; a failed build raises; ``levenshtein_plain`` is the
Python dynamic programme it is held against), ``EvaluationTokenizer``
(sacrebleu tokenization, imported only for a tokenizer other than
``none``, then optional punctuation removal, character tokenization and
lowercasing) and the ``wer`` scorer."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import host_library
from ..config.registry import register_scorer


def letter_words(dictionary, token_ids) -> list:
    """The words of a letter-label sequence (fairseq's ``post_process
    letter``): the symbols of the ids joined, ``|`` a word boundary, the
    specials (bos, pad, eos) left out."""
    special = {dictionary.pad(), dictionary.eos(), dictionary.bos()}
    return "".join(dictionary[int(t)] for t in token_ids if int(t) not in special
                   ).replace("|", " ").split()


def levenshtein(a, b) -> int:
    """Edit distance of two sequences of hashable items (unit insertions,
    deletions and substitutions), by the C++ routine over the items' ids in
    a table of the pair's distinct items."""
    ids: dict = {}
    aa, bb = (np.asarray([ids.setdefault(x, len(ids)) for x in seq], np.int32)
              for seq in (a, b))
    return int(host_library.libbleu().chimera_levenshtein(aa.ctypes.data, len(aa),
                                                          bb.ctypes.data, len(bb)))


def levenshtein_plain(a, b) -> int:
    """``levenshtein`` as a Python dynamic programme."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class EvaluationTokenizer:
    SPACE = chr(32)
    SPACE_ESCAPE = chr(9601)

    def __init__(self, tokenizer_type: str = "13a", lowercase: bool = False,
                 punctuation_removal: bool = False, character_tokenization: bool = False):
        self.lowercase = lowercase
        self.punctuation_removal = punctuation_removal
        self.character_tokenization = character_tokenization
        self._tok = None
        if tokenizer_type and tokenizer_type != "none":
            try:
                from sacrebleu.tokenizers.tokenizer_13a import Tokenizer13a
                from sacrebleu.tokenizers.tokenizer_intl import TokenizerV14International

                table = {"13a": Tokenizer13a, "intl": TokenizerV14International}
                try:
                    from sacrebleu.tokenizers.tokenizer_zh import TokenizerZh

                    table["zh"] = TokenizerZh
                except ImportError:
                    pass
                try:
                    from sacrebleu.tokenizers.tokenizer_char import TokenizerChar

                    table["char"] = TokenizerChar
                except ImportError:
                    pass
                if tokenizer_type not in table:
                    raise ValueError(f"unsupported wer tokenizer {tokenizer_type!r} "
                                     f"(available: {sorted(table) + ['none']})")
                self._tok = table[tokenizer_type]()
            except ImportError:
                self._tok = None

    @classmethod
    def remove_punctuation(cls, sent: str) -> str:
        import unicodedata

        return cls.SPACE.join(t for t in sent.split(cls.SPACE)
                              if not all(unicodedata.category(c)[0] == "P" for c in t))

    def tokenize(self, sent: str) -> str:
        if self._tok is not None:
            sent = self._tok(sent)
        if self.punctuation_removal:
            sent = self.remove_punctuation(sent)
        if self.character_tokenization:
            sent = self.SPACE.join(list(sent.replace(self.SPACE, self.SPACE_ESCAPE)))
        if self.lowercase:
            sent = sent.lower()
        return sent


@register_scorer("wer")
class WerScorer:
    def __init__(self, cfg: Optional[dict] = None, tgt_dict=None):
        cfg = cfg or {}
        self.tokenizer = EvaluationTokenizer(
            tokenizer_type=cfg.get("wer_tokenizer", "none"),
            lowercase=bool(cfg.get("wer_lowercase", False)),
            punctuation_removal=bool(cfg.get("wer_remove_punct", False)),
            character_tokenization=bool(cfg.get("wer_char_level", False)))
        self.distance = 0
        self.ref_length = 0

    def reset(self):
        self.distance = 0
        self.ref_length = 0

    def add_string(self, ref: str, pred: str):
        ref_words = self.tokenizer.tokenize(ref).split()
        pred_words = self.tokenizer.tokenize(pred).split()
        self.distance += levenshtein(ref_words, pred_words)
        self.ref_length += len(ref_words)

    def score(self) -> float:
        return 100.0 * self.distance / max(self.ref_length, 1)

    def result_string(self) -> str:
        return f"WER: {self.score():.2f}"
