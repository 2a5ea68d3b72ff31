"""Noising of token sequences for denoising and back-translation training
(own copy of chimera_st_tpu/data/noising.py; fairseq ``data/noising.py``'s
``WordDropout``, ``WordShuffle`` and ``NoisingDataset``): numpy transforms
of token id arrays with a trailing eos, drawn from the same
``np.random.Generator`` calls as the JAX package's, so the noised items of
both packages are equal array for array.

A word starts at every token whose predecessor does not end with the BPE
continuation marker (``@@``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class WordNoising:
    def __init__(self, dictionary, bpe_cont_marker: Optional[str] = "@@"):
        self.dictionary = dictionary
        self.bpe_cont = bpe_cont_marker

    def _word_starts(self, tokens: np.ndarray) -> np.ndarray:
        if self.bpe_cont is None:
            return np.ones(len(tokens), bool)
        is_cont_prev = np.array(
            [self.dictionary[int(t)].endswith(self.bpe_cont) for t in tokens]
        )
        starts = np.ones(len(tokens), bool)
        starts[1:] = ~is_cont_prev[:-1]
        return starts


class WordDropout(WordNoising):
    """Drop whole words with probability p (always keeping one); with
    ``blank_idx`` blank them instead of removing them."""

    def noising(
        self,
        tokens: np.ndarray,
        dropout_prob: float = 0.1,
        blank_idx: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        rng = rng or np.random.default_rng()
        has_eos = len(tokens) > 0 and tokens[-1] == self.dictionary.eos()
        body = tokens[:-1] if has_eos else tokens
        if len(body) == 0:
            return tokens.copy()
        starts = self._word_starts(body)
        word_ids = np.cumsum(starts) - 1
        n_words = word_ids[-1] + 1
        drop = rng.random(n_words) < dropout_prob
        if drop.all():  # always keep at least one word
            drop[rng.integers(n_words)] = False
        keep_tok = ~drop[word_ids]
        if blank_idx is not None:
            out = np.where(keep_tok, body, blank_idx)
        else:
            out = body[keep_tok]
        if has_eos:
            out = np.concatenate([out, [self.dictionary.eos()]])
        return out.astype(tokens.dtype)


class WordShuffle(WordNoising):
    """Shuffle words within a window of ``max_shuffle_distance``: U(0, k)
    noise added to the word positions, then a stable sort."""

    def noising(
        self,
        tokens: np.ndarray,
        max_shuffle_distance: int = 3,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if max_shuffle_distance <= 0:
            return tokens.copy()
        has_eos = len(tokens) > 0 and tokens[-1] == self.dictionary.eos()
        body = tokens[:-1] if has_eos else tokens
        if len(body) == 0:
            return tokens.copy()
        starts = self._word_starts(body)
        word_ids = np.cumsum(starts) - 1
        n_words = word_ids[-1] + 1
        noise = rng.uniform(0, max_shuffle_distance, size=n_words)
        order = np.argsort(np.arange(n_words) + noise, kind="stable")
        # reassemble words in the new order
        pieces = [body[word_ids == w] for w in order]
        out = np.concatenate(pieces) if pieces else body
        if has_eos:
            out = np.concatenate([out, [self.dictionary.eos()]])
        return out.astype(tokens.dtype)


class NoisingDataset:
    """A token dataset shuffled then word-dropped on each access, from the
    numpy stream of (seed, index)."""

    def __init__(
        self,
        src_dataset,
        src_dict,
        seed: int = 1,
        dropout_prob: float = 0.1,
        blank_idx: Optional[int] = None,
        max_shuffle_distance: int = 3,
        bpe_cont_marker: Optional[str] = "@@",
    ):
        self.dataset = src_dataset
        self.dropout = WordDropout(src_dict, bpe_cont_marker)
        self.shuffle = WordShuffle(src_dict, bpe_cont_marker)
        self.seed = seed
        self.dropout_prob = dropout_prob
        self.blank_idx = blank_idx
        self.max_shuffle_distance = max_shuffle_distance

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, index])
        tokens = np.asarray(self.dataset[index])
        tokens = self.shuffle.noising(tokens, self.max_shuffle_distance, rng)
        tokens = self.dropout.noising(tokens, self.dropout_prob, self.blank_idx, rng)
        return tokens
