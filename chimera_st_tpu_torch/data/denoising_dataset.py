"""BART's denoising noise on the host (own copy of
chimera_st_tpu/data/denoising_dataset.py; reference fairseq
data/denoising_dataset.py): sentence permutation, span masking with text
infilling (``replace_length`` 1 collapses a span to one ``<mask>``, -1
keeps its length, 0 deletes it), random-token substitution
(``mask_random``), insertion and rolling noise. Each item's noise comes
from ``numpy.random.default_rng([seed, epoch, index])`` and the draws are
taken in the JAX package's order, so a noised batch is array-equal to the
JAX package's.

An item is (noised source, original target); the collater emits the
seq2seq batch (``src_tokens`` / ``prev_output_tokens`` / ``target``) the
label-smoothed cross entropy reads, ``prev_output_tokens`` each target's
last token rotated to the front (with a language tag appended, the tag
leads the decoder's input).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from .batching import collate_tokens


def permute_sentences(
    source: np.ndarray, full_stop_idx: int, p: float, rng: np.random.Generator
) -> np.ndarray:
    """Shuffle a fraction ``p`` of the full-stop-delimited sentences
    (reference: denoising_dataset.py:218-239). ``source`` = [bos, ..., eos]."""
    full_stops = source == full_stop_idx
    full_stops[-2] = True  # last span counts as a sentence
    ends = np.flatnonzero(full_stops[1:] & ~full_stops[:-1]) + 2
    n = len(ends)
    if n <= 1:
        return source
    num_to_permute = math.ceil((n * 2 * p) / 2.0)
    substitutions = rng.permutation(n)[:num_to_permute]
    ordering = np.arange(n)
    ordering[substitutions] = substitutions[rng.permutation(num_to_permute)]
    result = source.copy()
    index = 1  # keep bos in place
    for i in ordering:
        start = ends[i - 1] if i > 0 else 1
        sentence = source[start : ends[i]]
        result[index : index + len(sentence)] = sentence
        index += len(sentence)
    return result


def add_insertion_noise(
    tokens: np.ndarray,
    p: float,
    mask_idx: int,
    vocab_size: int,
    rng: np.random.Generator,
    random_ratio: float = 0.0,
) -> np.ndarray:
    """Insert ceil(p*n) mask/random tokens at random inner positions
    (reference: denoising_dataset.py:372-393)."""
    if p <= 0.0:
        return tokens
    n = int(math.ceil(len(tokens) * p))
    noise_indices = rng.permutation(len(tokens) + n - 2)[:n] + 1
    noise_mask = np.zeros(len(tokens) + n, bool)
    noise_mask[noise_indices] = True
    result = np.full(len(tokens) + n, -1, tokens.dtype)
    num_random = int(math.ceil(n * random_ratio))
    result[noise_indices[num_random:]] = mask_idx
    if num_random:
        result[noise_indices[:num_random]] = rng.integers(
            1, vocab_size, size=num_random
        )
    result[~noise_mask] = tokens
    return result


def add_rolling_noise(tokens: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Rotate the inner tokens by a random offset (reference: :364-371)."""
    inner = len(tokens) - 2
    if inner <= 1:
        return tokens
    offset = int(rng.integers(1, inner + 1))
    return np.concatenate(
        [tokens[:1], tokens[1 + offset : -1], tokens[1 : 1 + offset], tokens[-1:]]
    )


def add_span_mask(
    tokens: np.ndarray,
    p: float,
    mask_idx: int,
    vocab_size: int,
    rng: np.random.Generator,
    random_ratio: float = 0.0,
    poisson_lambda: float = 0.0,  # 0: subword (span length 1)
    replace_length: int = -1,  # -1: keep span length, 1: one <mask>, 0: delete
) -> np.ndarray:
    """Mask ~p of the inner tokens (reference: :250-355 add_whole_word_mask;
    span-poisson + replace_length=1 is BART's text infilling)."""
    inner = len(tokens) - 2
    num_to_mask = int(math.ceil(inner * p))
    if num_to_mask <= 0 or inner <= 0:
        return tokens
    if poisson_lambda > 0:
        lengths: List[int] = []
        total = 0
        while total < num_to_mask:
            l = int(rng.poisson(poisson_lambda))
            if l == 0:
                l = 1  # the reference converts 0-length spans to insertions
            lengths.append(min(l, num_to_mask - total))
            total += lengths[-1]
    else:
        lengths = [1] * num_to_mask

    starts = rng.permutation(inner)[: len(lengths)] + 1  # skip bos
    keep = np.ones(len(tokens), bool)
    out = tokens.copy()
    for start, length in zip(starts, lengths):
        end = min(start + length, len(tokens) - 1)
        span = np.arange(start, end)
        if span.size == 0:
            continue
        if replace_length == 0:
            keep[span] = False
        elif replace_length == 1:
            head = span[0]
            out[head] = (
                rng.integers(1, vocab_size)
                if rng.random() < random_ratio
                else mask_idx
            )
            keep[span[1:]] = False
        else:  # -1: every masked token becomes mask/random, length kept
            rand = rng.random(span.size) < random_ratio
            out[span] = np.where(
                rand, rng.integers(1, vocab_size, size=span.size), mask_idx
            )
    return out[keep]


class DenoisingDataset:
    """Wraps a token-block dataset; items carry bos...eos framing."""

    def __init__(
        self,
        blocks,
        vocab_size: int,
        mask_idx: int,
        *,
        pad: int = 1,
        bos: int = 0,
        eos: int = 2,
        full_stop_idx: Optional[int] = None,
        mask: float = 0.0,
        mask_random: float = 0.0,
        insert: float = 0.0,
        rotate: float = 0.0,
        permute_sentence_ratio: float = 0.0,
        poisson_lambda: float = 0.0,
        replace_length: int = -1,
        seed: int = 1,
        append_tokens: Optional[np.ndarray] = None,  # e.g. language tag
    ):
        self.blocks = blocks
        self.vocab_size = vocab_size
        self.mask_idx = mask_idx
        self.pad, self.bos, self.eos = pad, bos, eos
        self.full_stop_idx = full_stop_idx
        self.mask = mask
        self.mask_random = mask_random
        self.insert = insert
        self.rotate = rotate
        self.permute_sentence_ratio = permute_sentence_ratio
        self.poisson_lambda = poisson_lambda
        self.replace_length = replace_length
        self.seed = seed
        self.epoch = 0
        self.append_tokens = append_tokens

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.blocks)

    def num_tokens(self, i: int) -> int:
        return self.blocks.num_tokens(i) + 2

    def _framed(self, tokens: np.ndarray) -> np.ndarray:
        # with append_tokens (a language tag) the item is [bos, ..., eos,
        # lang]: the noise protects only the first and last positions, so
        # the eos before the tag can be masked, permuted or rotated, as in
        # fairseq (denoising_dataset.py:240-247)
        parts = [np.array([self.bos], tokens.dtype), tokens]
        if tokens[-1] != self.eos:
            parts.append(np.array([self.eos], tokens.dtype))
        framed = np.concatenate(parts)
        if self.append_tokens is not None:
            framed = np.concatenate([framed, self.append_tokens.astype(framed.dtype)])
        return framed

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, self.epoch, index])
        target = self._framed(np.asarray(self.blocks[index]))
        source = target
        if self.permute_sentence_ratio > 0 and self.full_stop_idx is not None:
            source = permute_sentences(
                source, self.full_stop_idx, self.permute_sentence_ratio, rng
            )
        if self.mask > 0:
            source = add_span_mask(
                source, self.mask, self.mask_idx, self.vocab_size, rng,
                random_ratio=self.mask_random,
                poisson_lambda=self.poisson_lambda,
                replace_length=self.replace_length,
            )
        if self.insert > 0:
            source = add_insertion_noise(
                source, self.insert, self.mask_idx, self.vocab_size, rng,
                random_ratio=self.mask_random,
            )
        if self.rotate > 0 and rng.random() < self.rotate:
            source = add_rolling_noise(source, rng)
        return {"id": index, "source": source, "target": target}

    def collater(
        self,
        samples: List[Dict],
        src_target_len: Optional[int] = None,
        tgt_target_len: Optional[int] = None,
    ) -> Dict:
        if not samples:
            return {}
        src = collate_tokens(
            [s["source"] for s in samples], self.pad,
            target_len=src_target_len, dtype=np.int32,
        )
        tgt = collate_tokens(
            [s["target"] for s in samples], self.pad,
            target_len=tgt_target_len, dtype=np.int32,
        )
        # each row's last token rotated to the front (fairseq
        # move_eos_to_beginning): the language tag where one is appended
        prev = collate_tokens(
            [
                np.concatenate([s["target"][-1:], s["target"][:-1]])
                for s in samples
            ],
            self.pad, target_len=tgt_target_len, dtype=np.int32,
        )
        return {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "src_tokens": src,
            "prev_output_tokens": prev,
            "target": tgt,
            "ntokens": float(sum(len(s["target"]) for s in samples)),
            "nsentences": len(samples),
        }
