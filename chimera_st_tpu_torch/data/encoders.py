"""Subword/tokenizer encoder registry (own copy of
chimera_st_tpu/data/encoders.py): the ``sentencepiece``, ``bytes`` and
``characters`` encoders here, the subword BPEs in :mod:`.encoders_bpe`, and
the ``space``, ``nltk`` and ``moses`` tokenizers (``nltk`` and
``sacremoses`` imported by their constructors).

Each encoder: encode(str) -> str of space-joined tokens; decode(str) -> str.
`sentencepiece` uses the sentencepiece wheel where one is installed and the
native unigram implementation in :mod:`.spm` where not."""

from __future__ import annotations

from typing import Dict, Optional

from ..config.registry import BPE, TOKENIZERS, register_bpe, register_tokenizer


@register_bpe("sentencepiece")
class SentencepieceBPE:
    def __init__(self, cfg: Dict):
        model_path = cfg.get("sentencepiece_model", cfg.get("sentencepiece_model_fn"))
        if not model_path:
            raise ValueError("sentencepiece model path required")
        try:
            import sentencepiece as spm_lib  # optional wheel

            self._sp = spm_lib.SentencePieceProcessor()
            self._sp.Load(model_path)
            self._native = None
        except ImportError:
            from .spm import SentencePieceUnigram

            self._sp = None
            self._native = SentencePieceUnigram.load(model_path)

    def encode(self, text: str) -> str:
        if self._sp is not None:
            return " ".join(self._sp.EncodeAsPieces(text))
        return " ".join(self._native.encode_pieces(text))

    def decode(self, text: str) -> str:
        return text.replace(" ", "").replace("▁", " ").strip()


@register_bpe("bytes")
class Bytes:
    def __init__(self, cfg: Dict):
        pass

    def encode(self, text: str) -> str:
        return " ".join(f"<{b:02x}>" for b in text.encode("utf-8"))

    def decode(self, text: str) -> str:
        data = bytes(int(t[1:-1], 16) for t in text.split() if t.startswith("<"))
        return data.decode("utf-8", errors="replace")


@register_bpe("characters")
class Characters:
    def __init__(self, cfg: Dict):
        pass

    def encode(self, text: str) -> str:
        return " ".join("|" if c == " " else c for c in text)

    def decode(self, text: str) -> str:
        return text.replace(" ", "").replace("|", " ").strip()


@register_tokenizer("space")
class SpaceTokenizer:
    def __init__(self, cfg: Dict):
        pass

    def encode(self, text: str) -> str:
        return " ".join(text.split())

    def decode(self, text: str) -> str:
        return text


@register_tokenizer("nltk")
class NLTKTokenizer:
    def __init__(self, cfg: Dict):
        from nltk.tokenize import word_tokenize

        self._tok = word_tokenize

    def encode(self, text: str) -> str:
        return " ".join(self._tok(text))

    def decode(self, text: str) -> str:
        return text


@register_tokenizer("moses")
class MosesTokenizer:
    def __init__(self, cfg: Dict):
        from sacremoses import MosesDetokenizer, MosesTokenizer as MT

        lang = cfg.get("source_lang", "en")
        self._tok = MT(lang=lang)
        self._detok = MosesDetokenizer(lang=cfg.get("target_lang", lang))

    def encode(self, text: str) -> str:
        return self._tok.tokenize(text, return_str=True)

    def decode(self, text: str) -> str:
        return self._detok.detokenize(text.split())


def build_bpe(cfg: Optional[Dict]):
    if not cfg or not cfg.get("_name") or cfg.get("_name") == "none":
        return None
    return BPE.get(cfg["_name"])(cfg)


def build_tokenizer(cfg: Optional[Dict]):
    if not cfg or not cfg.get("_name") or cfg.get("_name") == "none":
        return None
    return TOKENIZERS.get(cfg["_name"])(cfg)


from . import encoders_bpe  # noqa: F401,E402 — registers the subword BPEs
