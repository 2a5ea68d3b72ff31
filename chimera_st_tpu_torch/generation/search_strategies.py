"""Constrained and diverse candidate selection for the beam search (own copy
of chimera_st_tpu/generation/search_strategies.py).

The reference's Python state machines become per-beam tensors on the device
that the ``SearchStrategy`` hooks carry through the decode loop: a lexical
constraint's state is an integer progress pointer per beam, the candidate
pools have a fixed size, and the dynamic beam allocation of Post & Vilar
(2018) becomes a (stripe, score) ordering. No hook reads a value back to the
host. Every sort and top-k here breaks ties toward the lower index, as
``jnp.argsort`` (stable) and ``jax.lax.top_k`` do.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .beam_search import NEG_INF, SearchStrategy, _top_k


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, dim=1, stable=True)


class PrefixConstrainedSearch(SearchStrategy):
    """Masks the log-probs through a callback ``allowed_fn(alive_seq [B, K,
    L], step) -> [B, K, V]``: a boolean allowed-mask, or an additive float
    mask (0 allowed, -inf banned)."""

    def __init__(self, allowed_fn: Callable):
        self.allowed_fn = allowed_fn

    def adjust(self, logprobs, state, step, alive_seq):
        mask = self.allowed_fn(alive_seq, step)
        if mask.dtype == torch.bool:
            return torch.where(mask, logprobs, NEG_INF)
        return logprobs + mask.to(logprobs.dtype)


class DiverseSiblingsSearch(SearchStrategy):
    """Sibling rank penalty (Li & Jurafsky 2016): within each beam the rank-r
    candidate (r from 1) loses ``r * diversity_rate``, which stays in the
    hypothesis's cumulative score; the top 2K of all K * 2K penalised
    candidates are kept."""

    def __init__(self, diversity_rate: float):
        self.rate = float(diversity_rate)

    def select(self, alive_scores, logprobs, state, step):
        B, K, V = logprobs.shape
        k = 2 * K
        s, t = _top_k(alive_scores[:, :, None] + logprobs, k)  # [B, K, 2K]
        ranks = torch.arange(1, k + 1, dtype=s.dtype, device=s.device)
        s = s - (ranks * self.rate)[None, None, :]
        top_s, idx = _top_k(s.reshape(B, K * k), k)
        return top_s, idx // k, torch.gather(t.reshape(B, K * k), 1, idx)


def _bank_stripe_pick(pool_s: torch.Tensor, banks: torch.Tensor, k2: int) -> torch.Tensor:
    """k2 pool indices in the reference's dynamic-beam-allocation order:
    candidates sorted by (bank desc, score desc), striped by position within
    their bank, the stripes taken in turn (the best of every bank, highest
    bank first, then the second best of every bank, ...). All integer ranks;
    dead candidates (score at NEG_INF) last."""
    n_pool = pool_s.shape[1]
    dead = pool_s <= NEG_INF
    bank_i = torch.where(dead, -1, banks.to(torch.int64))
    max_bank = bank_i.max(dim=1, keepdim=True).values
    score_rank = _argsort(_argsort(-pool_s))
    key1 = (max_bank - bank_i) * n_pool + score_rank
    rank1 = _argsort(_argsort(key1))
    same_bank = bank_i[:, :, None] == bank_i[:, None, :]
    ahead = rank1[:, None, :] < rank1[:, :, None]
    stripe = (same_bank & ahead).sum(dim=2)
    order_key = torch.where(dead, n_pool * (n_pool + 2), stripe * (n_pool + 1) + rank1)
    return _argsort(order_key)[:, :k2]


def _dedupe(pool_s, pool_beam, pool_tok, vocab: int):
    """Scores of repeated (beam, token) pairs set to NEG_INF; the first
    occurrence stays."""
    n = pool_s.shape[1]
    key = pool_beam * vocab + pool_tok
    later = torch.arange(n, device=pool_s.device)
    dup = (key[:, :, None] == key[:, None, :]) & (later[None, :, None] > later[None, None, :])
    return torch.where(dup.any(dim=2), NEG_INF, pool_s)


def _ban_eos(logprobs, unfinished, eos: int):
    logprobs = logprobs.clone()
    logprobs[:, :, eos] = torch.where(unfinished, NEG_INF, logprobs[:, :, eos])
    return logprobs


class LexicallyConstrainedSearch(SearchStrategy):
    """Ordered lexical constraints. ``constraints`` [B, C] holds each
    sentence's phrases flattened into one token sequence, padded with
    ``pad``; a beam's state is its progress into it. The candidate pool is the
    flat top-2K plus one forced constraint-advancing candidate per beam;
    candidates are banked by progress and taken in (stripe, score) order;
    eos is banned until every constraint is met."""

    def __init__(self, constraints: torch.Tensor, pad: int = 1, eos: int = 2):
        self.constraints = constraints.to(torch.int64)
        self.pad, self.eos = pad, eos
        self.n_constraints = (self.constraints != pad).sum(dim=1)  # [B]

    def init_state(self, batch_size, beam_size, device):
        self.constraints = self.constraints.to(device)
        self.n_constraints = self.n_constraints.to(device)
        return torch.zeros((batch_size, beam_size), dtype=torch.int64, device=device)

    def adjust(self, logprobs, state, step, alive_seq):
        return _ban_eos(logprobs, state < self.n_constraints[:, None], self.eos)

    def _next_token(self, progress):
        C = self.constraints.shape[1]
        return torch.gather(self.constraints, 1, progress.clamp(max=C - 1))

    def _advanced(self, prog, tok):
        adv = (tok == self._next_token(prog)) & (prog < self.n_constraints[:, None])
        return prog + adv.to(prog.dtype)

    def select(self, alive_scores, logprobs, state, step):
        B, K, V = logprobs.shape
        k2 = 2 * K
        top_s, top_idx = _top_k((alive_scores[:, :, None] + logprobs).reshape(B, K * V), k2)
        nxt = self._next_token(state)
        forced_s = torch.where(
            state < self.n_constraints[:, None],
            alive_scores + torch.gather(logprobs, 2, nxt[..., None])[..., 0], NEG_INF)
        beams = torch.arange(K, device=state.device).expand(B, K)
        pool_s = torch.cat([top_s, forced_s], dim=1)
        pool_beam = torch.cat([top_idx // V, beams], dim=1)
        pool_tok = torch.cat([top_idx % V, nxt], dim=1)
        pool_s = _dedupe(pool_s, pool_beam, pool_tok, V)
        banks = self._advanced(torch.gather(state, 1, pool_beam), pool_tok)
        pick = _bank_stripe_pick(pool_s, banks, k2)
        return tuple(torch.gather(x, 1, pick) for x in (pool_s, pool_beam, pool_tok))

    def update(self, state, topk_beam, topk_tok, alive_pick, step):
        beam = torch.gather(topk_beam, 1, alive_pick)
        tok = torch.gather(topk_tok, 1, alive_pick)
        return self._advanced(torch.gather(state, 1, beam), tok)


class UnorderedLexicallyConstrainedSearch(SearchStrategy):
    """Unordered lexical constraints: the phrases of ``phrases`` [B, P, L]
    (rows padded with ``pad``, P <= 31) may be met in any order. A beam's
    state is three integer planes: a bitmask of completed phrases, the phrase
    being matched (-1: none) and the position in it. A token continues the
    current phrase or falls back to the root (losing the partial match) and
    may start any open phrase, the lowest-indexed first; the bank is the
    number of constraint tokens held (completed phrases + progress). Each
    beam adds one candidate per phrase to the pool: the token that advances
    toward it."""

    def __init__(self, phrases: torch.Tensor, pad: int = 1, eos: int = 2):
        self.phrases = phrases.to(torch.int64)
        B, P, L = self.phrases.shape
        if P > 31:
            raise ValueError(f"at most 31 unordered phrases per sentence (got {P})")
        self.pad, self.eos = pad, eos
        self.lens = (self.phrases != pad).sum(dim=2)  # [B, P]
        self.total_tokens = self.lens.sum(dim=1)  # [B]

    def init_state(self, batch_size, beam_size, device):
        for name in ("phrases", "lens", "total_tokens"):
            setattr(self, name, getattr(self, name).to(device))
        z = torch.zeros((batch_size, beam_size), dtype=torch.int64, device=device)
        return {"mask": z, "cur": z - 1, "pos": z}

    def _bits(self, mask):
        P = self.phrases.shape[1]
        return (mask[..., None] >> torch.arange(P, device=mask.device)) & 1  # [B, N, P]

    def _completed_tokens(self, mask):
        return (self._bits(mask) * self.lens[:, None, :]).sum(dim=-1)

    def adjust(self, logprobs, state, step, alive_seq):
        unfinished = self._completed_tokens(state["mask"]) < self.total_tokens[:, None]
        return _ban_eos(logprobs, unfinished, self.eos)

    def _phrase_rows(self, cur_ix):
        """[B, N] phrase indices -> their rows [B, N, L]."""
        B, P, L = self.phrases.shape
        return torch.gather(self.phrases, 1, cur_ix[..., None].expand(-1, -1, L))

    def _advance(self, mask, cur, pos, tok):
        """(mask, cur, pos) x token -> the next state; all [B, N]."""
        B, P, L = self.phrases.shape
        cur_ix = cur.clamp(0, P - 1)
        pos_ix = pos.clamp(0, L - 1)
        cont_tok = torch.gather(self._phrase_rows(cur_ix), 2, pos_ix[..., None])[..., 0]
        cur_len = torch.gather(self.lens, 1, cur_ix)
        continuing = (cur >= 0) & (tok == cont_tok)
        done_cont = continuing & (pos + 1 >= cur_len)

        first = self.phrases[:, :, 0]  # [B, P]
        open_p = (self.lens[:, None, :] > 0) & (self._bits(mask) == 0)  # [B, N, P]
        startable = open_p & (tok[..., None] == first[:, None, :])
        any_start = startable.any(dim=-1)
        p_star = startable.to(torch.int8).argmax(dim=-1)  # the first open phrase it starts
        start_len = torch.gather(self.lens, 1, p_star)
        done_start = any_start & (start_len <= 1)

        new_mask = torch.where(done_cont, mask | (1 << cur_ix),
                               torch.where(done_start & ~continuing, mask | (1 << p_star), mask))
        starting = any_start & ~done_start
        new_cur = torch.where(continuing, torch.where(done_cont, -1, cur),
                              torch.where(starting, p_star, -1))
        new_pos = torch.where(continuing, torch.where(done_cont, 0, pos + 1),
                              torch.where(starting, 1, 0))
        return new_mask, new_cur, new_pos

    def select(self, alive_scores, logprobs, state, step):
        B, K, V = logprobs.shape
        P, L = self.phrases.shape[1:]
        k2 = 2 * K
        top_s, top_idx = _top_k((alive_scores[:, :, None] + logprobs).reshape(B, K * V), k2)

        mask, cur, pos = state["mask"], state["cur"], state["pos"]
        phrase_ids = torch.arange(P, device=mask.device)
        is_cur = cur[..., None] == phrase_ids  # [B, K, P]
        pos_ix = pos.clamp(0, L - 1)
        cont_tok = torch.gather(self.phrases[:, None].expand(B, K, P, L), 3,
                                pos_ix[:, :, None, None].expand(B, K, P, 1))[..., 0]
        first = self.phrases[:, None, :, 0].expand(B, K, P)
        adv_tok = torch.where(is_cur, cont_tok, first)
        open_p = (self.lens[:, None, :] > 0) & (self._bits(mask) == 0)
        forced_s = torch.where(open_p | is_cur,
                               alive_scores[..., None] + torch.gather(logprobs, 2, adv_tok),
                               NEG_INF).reshape(B, K * P)
        beams = torch.arange(K, device=mask.device)[:, None].expand(K, P).reshape(1, K * P)
        pool_s = torch.cat([top_s, forced_s], dim=1)
        pool_beam = torch.cat([top_idx // V, beams.expand(B, -1)], dim=1)
        pool_tok = torch.cat([top_idx % V, adv_tok.reshape(B, K * P)], dim=1)
        pool_s = _dedupe(pool_s, pool_beam, pool_tok, V)

        nm, nc, np_ = self._advance(*(torch.gather(x, 1, pool_beam) for x in (mask, cur, pos)),
                                    pool_tok)
        banks = self._completed_tokens(nm) + np_
        pick = _bank_stripe_pick(pool_s, banks, k2)
        return tuple(torch.gather(x, 1, pick) for x in (pool_s, pool_beam, pool_tok))

    def update(self, state, topk_beam, topk_tok, alive_pick, step):
        beam = torch.gather(topk_beam, 1, alive_pick)
        tok = torch.gather(topk_tok, 1, alive_pick)
        nm, nc, np_ = self._advance(*(torch.gather(state[k], 1, beam)
                                      for k in ("mask", "cur", "pos")), tok)
        return {"mask": nm, "cur": nc, "pos": np_}


def pack_constraint_phrases(batch_phrases: Sequence[Sequence[Sequence[int]]],
                            pad: int = 1) -> torch.Tensor:
    """Per sentence a list of phrases (token lists) -> the [B, P, L] phrase
    table of the unordered strategy, padded with ``pad``."""
    P = max((len(ps) for ps in batch_phrases), default=1) or 1
    L = max((len(p) for ps in batch_phrases for p in ps), default=1) or 1
    out = np.full((len(batch_phrases), P, L), pad, np.int32)
    for i, ps in enumerate(batch_phrases):
        for j, p in enumerate(ps):
            out[i, j, :len(p)] = p
    return torch.from_numpy(out)


def pack_constraints(batch_phrases: Sequence[Sequence[Sequence[int]]],
                     pad: int = 1) -> torch.Tensor:
    """Per sentence a list of phrases -> the ordered strategy's flat [B, C]
    constraint rows, padded with ``pad``."""
    flat = [[t for phrase in phrases for t in phrase] for phrases in batch_phrases]
    C = max((len(f) for f in flat), default=1) or 1
    out = np.full((len(flat), C), pad, np.int32)
    for i, f in enumerate(flat):
        out[i, :len(f)] = f
    return torch.from_numpy(out)
