"""Sampling decode (counterpart of chimera_st_tpu/generation/sampling.py):
K independent samples per sentence, with top-k and top-p (nucleus)
filtering.

The draws come from an explicit ``torch.Generator`` (Gumbel-max over the
filtered log-probs, as ``jax.random.categorical`` draws); they cannot equal
the JAX package's, whose generator differs, but the filtered distributions
do, value for value. The temperature is not applied here: ``step_fn``
returns tempered log-probs already. The caches keep the beam search's layout
with an ancestry that is never permuted: each sample reads its own column.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

NEG_INF = -1.0e7


def _filter_topk(logprobs: torch.Tensor, k: int) -> torch.Tensor:
    """Entries below the k-th largest set to NEG_INF (ties with it kept)."""
    if k <= 0:
        return logprobs
    kth = torch.topk(logprobs, k, dim=-1).values[..., -1:]
    return torch.where(logprobs < kth, NEG_INF, logprobs)


def _filter_topp(logprobs: torch.Tensor, p: float) -> torch.Tensor:
    """Keeps the smallest set of the most likely entries whose probability
    mass reaches ``p``; the rest set to NEG_INF."""
    if p <= 0 or p >= 1:
        return logprobs
    sorted_lp = torch.sort(logprobs, dim=-1, descending=True).values
    probs = torch.exp(sorted_lp)
    keep_sorted = torch.cumsum(probs, dim=-1) - probs < p
    thresh = torch.where(keep_sorted, sorted_lp, torch.inf).min(dim=-1, keepdim=True).values
    return torch.where(logprobs < thresh, NEG_INF, logprobs)


def draw(filtered: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token per row of ``filtered`` [N, V] (log-probs, NEG_INF for
    excluded entries), by Gumbel-max with uniforms from ``generator``."""
    u = torch.rand(filtered.shape, generator=generator, device=filtered.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(filtered + gumbel, dim=-1)


def sample_decode(
    step_fn: Callable,  # (tokens [B*K, 1], index, caches) -> (logprobs [B*K, V] fp32, caches)
    init_caches: Any,
    batch_size: int,
    num_samples: int,
    max_len: int,
    eos: int,
    pad: int,
    generator: torch.Generator,
    device,
    bos: Optional[int] = None,
    top_k: int = 0,
    top_p: float = 0.0,
    min_len: int = 1,
    max_lens: Optional[torch.Tensor] = None,  # [B] per-sentence max real tokens
    min_lens: Optional[torch.Tensor] = None,  # [B] per-sentence eos floor
    len_penalty: float = 1.0,
    unk: Optional[int] = None,
    unk_penalty: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, K, max_len], scores [B, K], lengths [B, K]), the
    samples of a sentence sorted by score (sum of log-probs / length **
    len_penalty), best first. One host read a step (all samples done?)."""
    B, K = batch_size, num_samples
    N = B * K
    if bos is None:
        bos = eos
    if max_lens is None:
        max_lens = torch.full((B,), max_len, dtype=torch.int32, device=device)
    max_lens = torch.clamp(max_lens, max=max_len - 1).to(torch.int32)
    max_steps = int(max_lens.max()) + 1
    max_rows = max_lens.repeat_interleave(K)  # [N]
    eff_min = torch.full((N,), min_len, dtype=torch.int32, device=device)
    if min_lens is not None:
        eff_min = torch.clamp(min_lens.repeat_interleave(K), min=min_len)

    seq = torch.full((N, max_len + 1), pad, dtype=torch.long, device=device)
    seq[:, 0] = bos
    scores = torch.zeros((N,), dtype=torch.float32, device=device)
    lens = torch.zeros((N,), dtype=torch.int32, device=device)
    done = torch.zeros((N,), dtype=torch.bool, device=device)
    caches = init_caches
    i = 0
    while i < max_steps and not bool(done.all()):
        logprobs, caches = step_fn(seq[:, i:i + 1], i, caches)
        logprobs = logprobs.float().clone()
        gen_len = i + 1
        logprobs[:, pad] = NEG_INF
        if unk is not None and unk_penalty != 0.0:
            logprobs[:, unk] -= unk_penalty
        logprobs[:, eos] = torch.where(gen_len <= eff_min, NEG_INF, logprobs[:, eos])
        eos_only = torch.full_like(logprobs, NEG_INF)
        eos_only[:, eos] = logprobs[:, eos]
        logprobs = torch.where((gen_len > max_rows)[:, None], eos_only, logprobs)

        tok = draw(_filter_topp(_filter_topk(logprobs, top_k), top_p), generator)
        tok = torch.where(done, pad, tok)
        step_lp = torch.gather(logprobs, 1, tok[:, None])[:, 0]
        scores = scores + torch.where(done, 0.0, step_lp)
        seq[:, i + 1] = tok
        lens = torch.where((tok == eos) & ~done, gen_len, lens)
        done = done | (tok == eos)
        i += 1

    lens = torch.where(done, lens, max_rows + 1)
    divisor = torch.clamp(lens, min=1).to(torch.float32) ** len_penalty
    scores = (scores / divisor).reshape(B, K)
    tokens = seq[:, 1:].reshape(B, K, max_len)
    lens = lens.reshape(B, K)
    order = torch.argsort(-scores, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[:, :, None].expand_as(tokens))
    scores = torch.gather(scores, 1, order)
    lens = torch.gather(lens, 1, order)
    pos = torch.arange(max_len, device=device)[None, None, :]
    tokens = torch.where(pos < lens[:, :, None], tokens, pad)
    return tokens, scores, lens
