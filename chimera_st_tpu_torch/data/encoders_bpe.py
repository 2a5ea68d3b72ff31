"""Subword BPE encoders (own copy of chimera_st_tpu/data/encoders_bpe.py):
``gpt2`` / ``gpt2_bpe``, ``subword_nmt``, ``fastbpe``, ``byte_bpe``,
``bert`` / ``hf_bert_bpe`` and ``hf_byte_bpe``.

- gpt2: byte-level BPE over ``encoder.json`` + ``vocab.bpe`` merge ranks with
  the GPT-2 regex pre-split (``regex``, imported by the constructor),
- subword_nmt / fastbpe: learned merge operations applied from a codes file
  with the ``@@ `` continuation convention (no external package),
- byte_bpe: UTF-8 bytes mapped to printable characters, then the native
  sentencepiece of :mod:`.spm` over the byte text,
- bert / hf_bert_bpe and hf_byte_bpe: ``transformers``' ``BertTokenizer`` and
  ``tokenizers``' ``ByteLevelBPETokenizer``, imported by the constructors.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, List, Tuple

from ..config.registry import register_bpe

# ----------------------------------------------------------------- gpt2_bpe


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 convention: printable
    ASCII/latin bytes map to themselves, the rest shift above 255)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    mapping = {}
    shift = 0
    for b in range(256):
        if b in printable:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class _BPEMerger:
    """Greedy lowest-rank-first merge loop shared by gpt2/subword-nmt."""

    def __init__(self, ranks: Dict[Tuple[str, str], int]):
        self.ranks = ranks
        self._cache: Dict[Tuple[str, ...], Tuple[str, ...]] = {}

    def merge(self, word: Tuple[str, ...]) -> Tuple[str, ...]:
        if word in self._cache:
            return self._cache[word]
        orig = word
        while len(word) > 1:
            pairs = _pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        self._cache[orig] = word
        return word


GPT2_SPLIT = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


@register_bpe("gpt2")
@register_bpe("gpt2_bpe")
class GPT2BPE:
    """GPT-2's byte-level BPE; cfg: gpt2_encoder_json, gpt2_vocab_bpe (file
    paths)."""

    def __init__(self, cfg: Dict):
        import regex

        with open(cfg["gpt2_encoder_json"], encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(cfg["gpt2_vocab_bpe"], encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines[1:] if len(l.split()) == 2]
        self.merger = _BPEMerger({m: i for i, m in enumerate(merges)})
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        self.pat = regex.compile(GPT2_SPLIT)

    def encode(self, text: str) -> str:
        ids: List[int] = []
        for tok in self.pat.findall(text):
            btok = tuple(self.byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self.merger.merge(btok))
        return " ".join(map(str, ids))

    def decode(self, text: str) -> str:
        pieces = [
            self.decoder[int(t)] if t.lstrip("-").isdigit() else t
            for t in text.split()
        ]
        raw = "".join(pieces)
        return bytearray(
            self.byte_dec.get(c, ord("?")) for c in raw
        ).decode("utf-8", errors="replace")

    def is_beginning_of_word(self, x: str) -> bool:
        return self.decode(x).startswith(" ")


class _CodesFileBPE:
    """Apply subword-nmt style merge codes with @@ continuation markers (the
    subword-nmt apply_bpe algorithm: word -> chars + '</w>', merge by learned
    rank)."""

    def __init__(self, codes_path: str, separator: str = "@@"):
        ranks: Dict[Tuple[str, str], int] = {}
        with open(codes_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                if i == 0 and line.startswith("#version"):
                    continue
                parts = line.split()
                # subword-nmt codes: "a b"; fastBPE learnbpe: "a b count"
                if len(parts) in (2, 3):
                    ranks[(parts[0], parts[1])] = len(ranks)
        self.merger = _BPEMerger(ranks)
        self.sep = separator

    def segment_word(self, word: str) -> List[str]:
        if not word:
            return []
        pieces = self.merger.merge(tuple(word[:-1]) + (word[-1] + "</w>",))
        out = []
        for j, p in enumerate(pieces):
            p = p[:-4] if p.endswith("</w>") else p + self.sep
            if p:
                out.append(p)
        return out

    def encode(self, text: str) -> str:
        return " ".join(
            piece for word in text.split() for piece in self.segment_word(word)
        )

    def decode(self, text: str) -> str:
        return (text + " ").replace(self.sep + " ", "").rstrip()


@register_bpe("subword_nmt")
class SubwordNMTBPE(_CodesFileBPE):
    def __init__(self, cfg: Dict):
        super().__init__(cfg["bpe_codes"], cfg.get("bpe_separator", "@@"))


@register_bpe("fastbpe")
class FastBPE(_CodesFileBPE):
    """Same codes-file application as subword_nmt (fastBPE's C++ binding
    exists for speed only; its output is the same)."""

    def __init__(self, cfg: Dict):
        super().__init__(cfg["bpe_codes"], cfg.get("bpe_separator", "@@"))


# ----------------------------------------------------------------- byte_bpe

SPACE = chr(32)
SPACE_ESCAPE = chr(9601)
_PRINTABLE = set(
    list(range(32, 127)) + list(range(161, 173)) + list(range(174, 256))
)
_BYTE_TO_BCHAR = {b: chr(b) if b in _PRINTABLE else chr(256 + b) for b in range(256)}
_BCHAR_TO_BYTE = {c: b for b, c in _BYTE_TO_BCHAR.items()}
_WS = re.compile(r"\s+")


def byte_encode(x: str) -> str:
    return "".join(_BYTE_TO_BCHAR[b] for b in _WS.sub(SPACE, x).encode("utf-8"))


def byte_decode(x: str) -> str:
    try:
        return bytes(_BCHAR_TO_BYTE[c] for c in x).decode("utf-8")
    except (ValueError, KeyError):
        return ""


def smart_byte_decode(x: str) -> str:
    """Best-effort decode of possibly-broken byte sequences: the most valid
    characters recovered by dynamic programming."""
    out = byte_decode(x)
    if out or not x:
        return out
    n = len(x)
    f = [0] * (n + 1)
    pt = [0] * (n + 1)
    for i in range(1, n + 1):
        f[i], pt[i] = f[i - 1], i - 1  # drop one byte-char
        for w in (1, 2, 3, 4):
            if i - w >= 0 and byte_decode(x[i - w : i]):
                if f[i - w] + 1 > f[i]:
                    f[i], pt[i] = f[i - w] + 1, i - w
    chunks = []
    i = n
    while i > 0:
        j = pt[i]
        piece = byte_decode(x[j:i])
        if piece:
            chunks.append(piece)
        i = j
    return "".join(reversed(chunks))


@register_bpe("byte_bpe")
class ByteBPE:
    """UTF-8 bytes -> printable chars -> native sentencepiece."""

    def __init__(self, cfg: Dict):
        from .spm import SentencePieceUnigram

        self.sp = SentencePieceUnigram.load(cfg["sentencepiece_model_path"])

    def encode(self, text: str) -> str:
        return " ".join(self.sp.encode_pieces(byte_encode(text)))

    def decode(self, text: str) -> str:
        joined = "".join(text.split(" ")).replace(SPACE_ESCAPE, SPACE)
        return smart_byte_decode(joined)


@register_bpe("bert")
@register_bpe("hf_bert_bpe")
class HuggingFaceBertBPE:
    """WordPiece via transformers' BertTokenizer. ``bpe_vocab_file`` points
    at a local vocab.txt; a model name instead (``bpe_model_name``) needs a
    populated Hugging Face cache."""

    def __init__(self, cfg: Dict):
        from transformers import BertTokenizer

        vocab = cfg.get("bpe_vocab_file")
        name = cfg.get("bpe_model_name", "bert-base-uncased")
        if vocab:
            self.tok = BertTokenizer(
                vocab, do_lower_case=bool(cfg.get("bpe_cased", False)) is False
            )
        else:
            self.tok = BertTokenizer.from_pretrained(name)

    def encode(self, text: str) -> str:
        return " ".join(self.tok.tokenize(text))

    def decode(self, text: str) -> str:
        return self.tok.clean_up_tokenization(
            self.tok.convert_tokens_to_string(text.split(" "))
        )

    def is_beginning_of_word(self, x: str) -> bool:
        return not x.startswith("##")


@register_bpe("hf_byte_bpe")
class HuggingFaceByteLevelBPE:
    """Byte-level BPE via the tokenizers library (ByteLevelBPETokenizer over
    the ``bpe_vocab`` / ``bpe_merges`` files)."""

    def __init__(self, cfg: Dict):
        from tokenizers import ByteLevelBPETokenizer

        vocab = cfg.get("bpe_vocab")
        merges = cfg.get("bpe_merges")
        if not (vocab and merges):
            raise ValueError("hf_byte_bpe needs bpe_vocab and bpe_merges files")
        self.tok = ByteLevelBPETokenizer(
            vocab, merges, add_prefix_space=bool(cfg.get("bpe_add_prefix_space",
                                                         False)),
        )

    def encode(self, text: str) -> str:
        return " ".join(map(str, self.tok.encode(text).ids))

    def decode(self, text: str) -> str:
        return self.tok.decode([int(t) for t in text.split(" ") if t])

    def is_beginning_of_word(self, x: str) -> bool:
        return self.decode(x).startswith(" ")
