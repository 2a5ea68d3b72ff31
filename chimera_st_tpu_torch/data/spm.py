"""Native sentencepiece **unigram** encoder (own copy of
chimera_st_tpu/data/spm.py).

The environment has no sentencepiece wheel, so this package carries its own
reader for SPM ``.model`` protobufs (hand-rolled wire-format walk — the schema
is tiny) plus Viterbi segmentation. It covers what the Chimera recipes need:
the unigram-10k joint vocabularies shipped in chimera/resources/*-spm/
(reference tokenizer use: fairseq/data/encoders/sentencepiece_bpe.py, config
written by chimera/prepare_data/data_utils.py:128-168).

Pipeline parity notes:
- normalization approximates nmt_nfkc with unicodedata NFKC + whitespace
  collapse (the precompiled charsmap includes a handful of extra mappings),
- add_dummy_prefix / escape_whitespaces per the model's NormalizerSpec,
- unknown characters segment to the UNK piece with sentencepiece's
  min_score - 10 penalty.
"""

from __future__ import annotations

import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

WS = "▁"  # ▁


def _parse_protobuf(data: bytes):
    """Yield (field_number, wire_type, value) triples."""
    i, n = 0, len(data)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wt, val
        elif wt == 1:  # 64-bit
            yield field, wt, data[i : i + 8]
            i += 8
        elif wt == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wt, data[i : i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            yield field, wt, data[i : i + 4]
            i += 4
        else:
            raise ValueError(f"bad wire type {wt} at {i}")


# SentencePiece.Type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, BYTE, UNUSED = 1, 2, 3, 4, 6, 5


class SentencePieceUnigram:
    def __init__(
        self,
        pieces: List[Tuple[str, float, int]],
        add_dummy_prefix: bool = True,
        remove_extra_whitespaces: bool = True,
    ):
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.unk_id = 0
        self.max_piece_len = 1
        min_score = 0.0
        for i, (p, score, typ) in enumerate(pieces):
            if p not in self.piece_to_id:
                self.piece_to_id[p] = i
            if typ == UNKNOWN:
                self.unk_id = i
            if typ == NORMAL:
                self.scores[p] = score
                min_score = min(min_score, score)
                self.max_piece_len = max(self.max_piece_len, len(p))
        self.unk_score = min_score - 10.0
        self.unk_piece = pieces[self.unk_id][0] if pieces else "<unk>"
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces

    # ------------------------------------------------------------------ I/O

    @classmethod
    def load(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            data = f.read()
        pieces: List[Tuple[str, float, int]] = []
        add_dummy_prefix = True
        remove_extra_ws = True
        for field, wt, val in _parse_protobuf(data):
            if field == 1 and wt == 2:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for f2, w2, v2 in _parse_protobuf(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        typ = v2
                pieces.append((piece, score, typ))
            elif field == 3 and wt == 2:  # NormalizerSpec
                for f2, w2, v2 in _parse_protobuf(val):
                    if f2 == 3 and w2 == 0:
                        add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        remove_extra_ws = bool(v2)
        return cls(pieces, add_dummy_prefix, remove_extra_ws)

    def __len__(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    # ------------------------------------------------------------- encoding

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", WS)

    def encode_pieces(self, text: str) -> List[str]:
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self.max_piece_len)
            for j in range(i + 1, hi + 1):
                sub = s[i:j]
                sc = self.scores.get(sub)
                if sc is not None and best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, sub)
            # unk fallback: single character
            j = i + 1
            if best[i] + self.unk_score > best[j]:
                best[j] = best[i] + self.unk_score
                back[j] = (i, s[i:j])
        out: List[str] = []
        j = n
        while j > 0:
            i, sub = back[j]
            out.append(sub if sub in self.scores else self.unk_piece)
            j = i
        out.reverse()
        return out

    def encode_ids(self, text: str) -> List[int]:
        return [self.piece_to_id.get(p, self.unk_id) for p in self.encode_pieces(text)]

    def decode_pieces(self, pieces: List[str]) -> str:
        return "".join(pieces).replace(WS, " ").strip()
