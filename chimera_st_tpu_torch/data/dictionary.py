"""Symbol dictionary (own copy of chimera_st_tpu/data/dictionary.py).

Behavior-compatible with the reference vocabulary format
(reference: fairseq/data/dictionary.py): a text file of ``<symbol> <count>``
lines loaded on top of the special symbols ``<s>``=0, ``<pad>``=1, ``</s>``=2,
``<unk>``=3, so indices match fairseq-binarized data and released checkpoints.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Union

import numpy as np

SPACE_NORMALIZER = re.compile(r"\s+")


def tokenize_line(line: str) -> List[str]:
    return SPACE_NORMALIZER.sub(" ", line).strip().split()


class Dictionary:
    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
        extra_special_symbols: Optional[Iterable[str]] = None,
    ):
        self.bos_word, self.unk_word, self.pad_word, self.eos_word = bos, unk, pad, eos
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices = {}
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        if extra_special_symbols:
            for s in extra_special_symbols:
                self.add_symbol(s)
        self.nspecial = len(self.symbols)

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        if 0 <= idx < len(self.symbols):
            return self.symbols[idx]
        return self.unk_word

    def __contains__(self, sym: str) -> bool:
        return sym in self.indices

    def __eq__(self, other) -> bool:
        return isinstance(other, Dictionary) and self.indices == other.indices

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

    def unk_string(self, escape: bool = False) -> str:
        return f"<{self.unk_word}>" if escape else self.unk_word

    def add_symbol(self, word: str, n: int = 1, overwrite: bool = False) -> int:
        if word in self.indices and not overwrite:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def set_lang_tags(self, langs: Iterable[str], template: str = "<lang:{}>"):
        for lang in langs:
            self.add_symbol(template.format(lang))

    # ------------------------------------------------------------------ I/O

    @classmethod
    def load(cls, path_or_file: Union[str, "object"]) -> "Dictionary":
        d = cls()
        d.add_from_file(path_or_file)
        return d

    def add_from_file(self, path_or_file) -> None:
        if isinstance(path_or_file, str):
            with open(path_or_file, "r", encoding="utf-8") as f:
                self.add_from_file(f)
            return
        for line in path_or_file.readlines():
            line = line.rstrip()
            if not line:
                continue
            if line.startswith("#fairseq:overwrite"):
                continue
            try:
                field, count = line.rsplit(" ", 1)
                if field.endswith("#fairseq:overwrite"):
                    field = field[: -len("#fairseq:overwrite")].rstrip()
                    self.add_symbol(field, n=int(count), overwrite=True)
                else:
                    if field in self.indices:
                        # reference raises here (dictionary.py "Duplicate
                        # word found"); merging would silently shift every
                        # later index
                        raise RuntimeError(
                            f"Duplicate word found when loading Dictionary: "
                            f"{field!r} — corrupt dict file? (append "
                            f"'#fairseq:overwrite' to override)"
                        )
                    self.add_symbol(field, n=int(count))
            except ValueError:
                raise ValueError(
                    f"Incorrect dictionary format: expected '<token> <cnt>', got {line!r}"
                )

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for sym, cnt in zip(
                self.symbols[self.nspecial :], self.count[self.nspecial :]
            ):
                f.write(f"{sym} {cnt}\n")

    def finalize(self, threshold: int = -1, nwords: int = -1, padding_factor: int = 8):
        """Sort non-special symbols by count (desc), trim, pad vocab size."""
        if nwords <= 0:
            nwords = len(self)
        specials = list(zip(self.symbols[: self.nspecial], self.count[: self.nspecial]))
        pairs = sorted(
            zip(self.symbols[self.nspecial :], self.count[self.nspecial :]),
            key=lambda kv: (-kv[1], kv[0]),
        )
        symbols, count, indices = [], [], {}
        for s, c in specials:
            indices[s] = len(symbols)
            symbols.append(s)
            count.append(c)
        for s, c in pairs:
            if len(symbols) >= nwords or (threshold > 0 and c < threshold):
                break
            indices[s] = len(symbols)
            symbols.append(s)
            count.append(c)
        self.symbols, self.count, self.indices = symbols, count, indices
        self.pad_to_multiple_(padding_factor)

    def pad_to_multiple_(self, padding_factor: int) -> None:
        if padding_factor > 1:
            i = 0
            while len(self) % padding_factor != 0:
                self.add_symbol(f"madeupword{i:04d}", n=0)
                i += 1

    # ------------------------------------------------------------- encoding

    def encode_line(
        self,
        line: str,
        line_tokenizer=tokenize_line,
        add_if_not_exist: bool = False,
        append_eos: bool = True,
        reverse_order: bool = False,
    ) -> np.ndarray:
        words = line_tokenizer(line)
        if reverse_order:
            words = list(reversed(words))
        ids = []
        for w in words:
            if add_if_not_exist:
                ids.append(self.add_symbol(w))
            else:
                ids.append(self.index(w))
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    def string(
        self,
        tensor,
        bpe_symbol: Optional[str] = None,
        escape_unk: bool = False,
        extra_symbols_to_ignore: Optional[set] = None,
        include_eos: bool = False,
    ) -> str:
        ignore = set(extra_symbols_to_ignore or [])
        if not include_eos:
            ignore.add(self.eos_index)
        tokens = [int(t) for t in np.asarray(tensor).reshape(-1)]
        out = []
        for i in tokens:
            if i in ignore or i == self.pad_index:
                continue
            if i == self.unk_index:
                out.append(self.unk_string(escape_unk))
            else:
                out.append(self[i])
        sent = " ".join(out)
        return post_process(sent, bpe_symbol)


def post_process(sentence: str, symbol: Optional[str]) -> str:
    """Join subwords back to words (reference: fairseq/data/data_utils.py:340)."""
    if symbol == "sentencepiece":
        sentence = sentence.replace(" ", "").replace("▁", " ").strip()
    elif symbol == "wordpiece":
        sentence = sentence.replace(" ", "").replace("_", " ").strip()
    elif symbol == "letter":
        sentence = sentence.replace(" ", "").replace("|", " ").strip()
    elif symbol == "_EOW":
        sentence = sentence.replace(" ", "").replace("_EOW", " ").strip()
    elif symbol is not None and symbol != "none":
        sentence = (sentence + " ").replace(symbol, "").rstrip()
    return sentence
