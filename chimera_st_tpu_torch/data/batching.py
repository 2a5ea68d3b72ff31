"""Token-budget batch packing + length bucketing (own copy of
chimera_st_tpu/data/batching.py).

`batch_by_size` reproduces the reference's packing semantics
(reference: fairseq/data/data_utils.py:276 + data_utils_fast.pyx:27-123):
walk indices (usually sorted by length), close a batch when adding the next
item would push ``max(len) * (n+1)`` over ``max_tokens`` or hit
``max_sentences``; closed batches are trimmed to a multiple of
``required_batch_size_multiple`` when larger than it. It packs with the
C++ routine ``csrc/libbleu.cpp`` ``chimera_batch_by_size_fast`` (g++ on
first use, ``host_library.py``; a failed build raises) unless an item is
over ``max_tokens``, as the JAX package's native path does;
``batch_by_size_plain`` is the Python loop it is held against, which raises
on such an item.

On top of that `optimal_buckets` (or `quantile_buckets`)/`pad_to_bucket` bound the number of distinct
batch shapes: each batch pads its time dimension up to a bucket edge instead
of the ragged batch max. The port keeps the JAX package's padded lengths
because they change results: the extractor's group norm spans the whole
padded time axis.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from .. import host_library


def _sizes(indices, num_tokens_fn) -> np.ndarray:
    if isinstance(num_tokens_fn, np.ndarray):
        return num_tokens_fn[indices]
    return np.asarray([num_tokens_fn(int(i)) for i in indices], dtype=np.int64)


def batch_by_size(
    indices: np.ndarray,
    num_tokens_fn: Union[Callable[[int], int], np.ndarray],
    max_tokens: Optional[int] = None,
    max_sentences: Optional[int] = None,
    required_batch_size_multiple: int = 1,
) -> List[np.ndarray]:
    """The batches of ``indices`` in walk order (see the module's
    docstring), packed by the C++ routine."""
    sizes = np.ascontiguousarray(_sizes(indices, num_tokens_fn), np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if max_tokens is not None and sizes.max(initial=0) > max_tokens:
        return _pack_plain(indices, sizes, max_tokens, max_sentences,
                           required_batch_size_multiple)
    ends = np.zeros(len(sizes) + 1, np.int64)
    n = host_library.libbleu().chimera_batch_by_size_fast(
        sizes.ctypes.data, len(sizes), max_tokens if max_tokens is not None else 2 ** 62,
        max_sentences if max_sentences is not None else 2 ** 62,
        required_batch_size_multiple, ends.ctypes.data)
    return list(np.split(indices, ends[:n - 1]))


def batch_by_size_plain(
    indices: np.ndarray,
    num_tokens_fn: Union[Callable[[int], int], np.ndarray],
    max_tokens: Optional[int] = None,
    max_sentences: Optional[int] = None,
    required_batch_size_multiple: int = 1,
) -> List[np.ndarray]:
    """``batch_by_size`` as a Python loop; raises ``ValueError`` on an item
    over ``max_tokens``."""
    return _pack_plain(np.asarray(indices, dtype=np.int64), _sizes(indices, num_tokens_fn),
                       max_tokens, max_sentences, required_batch_size_multiple)


def _pack_plain(indices, sizes, max_tokens, max_sentences, bsz_mult) -> List[np.ndarray]:
    max_tokens = max_tokens if max_tokens is not None else np.iinfo(np.int64).max
    max_sentences = (
        max_sentences if max_sentences is not None else np.iinfo(np.int64).max
    )

    batches: List[np.ndarray] = []
    batch: List[int] = []
    batch_sizes: List[int] = []
    sample_len = 0
    for idx, sz in zip(indices, sizes):
        sz = int(sz)
        sample_len = max(sample_len, sz)
        if sz > max_tokens:
            raise ValueError(
                f"sentence at index {idx} of size {sz} exceeds max_tokens {max_tokens}")
        num_tokens = (len(batch) + 1) * sample_len
        if batch and (len(batch) == max_sentences or num_tokens > max_tokens):
            mod_len = max(
                bsz_mult * (len(batch) // bsz_mult),
                len(batch) % bsz_mult,
            )
            batches.append(np.asarray(batch[:mod_len], dtype=np.int64))
            batch, batch_sizes = batch[mod_len:], batch_sizes[mod_len:]
            sample_len = max(batch_sizes + [sz])
        batch.append(int(idx))
        batch_sizes.append(sz)
    if batch:
        batches.append(np.asarray(batch, dtype=np.int64))
    return batches


def quantile_buckets(lengths: Sequence[int], n_buckets: int = 10) -> np.ndarray:
    """Bucket edges at length quantiles; last edge = max length."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, np.linspace(1.0 / n_buckets, 1.0, n_buckets))
    edges = np.unique(np.ceil(qs).astype(np.int64))
    edges[-1] = max(edges[-1], lengths.max())
    return edges


def optimal_buckets(lengths: Sequence[int], n_buckets: int = 10) -> np.ndarray:
    """Bucket edges minimizing TOTAL padded length when every item pads up to
    its smallest covering edge (exact DP over unique lengths, O(k·n²) via
    vectorized min; the last edge is always max(lengths)).

    `quantile_buckets` equalizes item COUNT per bucket, the wrong objective
    for padding waste on skewed duration distributions; this minimizes
    expected pad directly.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    uniq = np.unique(lengths)
    if len(uniq) <= n_buckets:
        return uniq
    # cap the candidate-edge set: the DP is O(k·n²) in candidates, and raw
    # audio corpora have ~one unique sample-length per utterance. 1024
    # quantile-spaced candidates keep the n² matrices ~8 MB and the result
    # within a fraction of a percent of the unrestricted optimum (edges are
    # still evaluated against the FULL length distribution below).
    if len(uniq) > 1024:
        qs = np.quantile(uniq, np.linspace(0.0, 1.0, 1024))
        uniq = np.unique(np.ceil(qs).astype(np.int64))
        uniq[-1] = lengths.max()
    # prefix count/sum of items with length <= uniq[i]
    order = np.sort(lengths)
    cnt = np.searchsorted(order, uniq, side="right").astype(np.float64)
    csum = np.concatenate([[0], np.cumsum(order)])[
        np.searchsorted(order, uniq, side="right")
    ].astype(np.float64)
    n = len(uniq)
    uf = uniq.astype(np.float64)
    # dp[k][b] = min cost of covering every item with length <= uniq[b]
    # using exactly k+1 edges, the topmost being uniq[b]
    dp = uf * cnt - csum  # k = 0: one edge at uniq[b]
    parent = np.full((n_buckets, n), -1, dtype=np.int64)
    for k in range(1, n_buckets):
        # cost(a, b) = items in (uniq[a], uniq[b]] padded to uniq[b]
        #            = uniq[b]*(cnt[b]-cnt[a]) - (csum[b]-csum[a])
        cand = (
            dp[None, :]
            + uf[:, None] * (cnt[:, None] - cnt[None, :])
            - (csum[:, None] - csum[None, :])
        )  # [b, a]
        cand[np.triu_indices(n)] = np.inf  # cand[b, a]: require a < b
        parent[k] = np.argmin(cand, axis=1)
        dp = cand[np.arange(n), parent[k]]
    # exactly n_buckets edges is optimal (extra edges never hurt: n > k)
    edges = []
    b, k = n - 1, n_buckets - 1
    while b >= 0:
        edges.append(uniq[b])
        if k == 0:
            break
        b, k = int(parent[k, b]), k - 1
    return np.asarray(sorted(edges), dtype=np.int64)


def round16(n: int) -> int:
    """Round a batch's pad length up to a multiple of 16."""
    return ((int(n) + 15) // 16) * 16


def round16_or_none(n):
    """round16 that passes None through (optional pad targets)."""
    return round16(n) if n else None


def pad_to_bucket(length: int, edges: np.ndarray) -> int:
    """Smallest bucket edge >= length (static-shape padding target)."""
    i = int(np.searchsorted(edges, length, side="left"))
    return int(edges[min(i, len(edges) - 1)]) if length <= edges[-1] else int(length)


def collate_tokens(
    sequences: List[np.ndarray],
    pad_value: Union[int, float],
    target_len: Optional[int] = None,
    dtype=None,
    left_pad: bool = False,
) -> np.ndarray:
    """Pad arrays along their first dim into [B, T, ...] (reference:
    data_utils.py:34 collate_tokens + _collate_frames for 2-D features,
    extended with a static target_len for bucketed shapes)."""
    seqs = [np.asarray(s) for s in sequences]
    max_len = max(len(s) for s in seqs)
    T = max(max_len, target_len or 0)
    dtype = dtype or seqs[0].dtype
    rest = seqs[0].shape[1:]
    out = np.full((len(seqs), T) + rest, pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        if left_pad:
            out[i, T - len(s) :] = s
        else:
            out[i, : len(s)] = s
    return out
