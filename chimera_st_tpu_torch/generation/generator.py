"""Sequence generator for speech translation, lazy-reorder beam search
(counterpart of chimera_st_tpu/generation/generator.py).

The encoder runs once per batch. The cross-attention K/V of every decoder
layer is projected once per sentence and stays UN-repeated [B, S, H, D]:
the beams of a sentence share it. The self-attention caches
[B*K, H, max_decode_len, D] are preallocated and written in place; the beam
search never permutes them. Instead an ancestry map [max_decode_len + 1,
B*K] is permuted (``reorder_fn``), and the attention kernel reads each
hypothesis's time-l entry from column ``ancestry[l, hyp]`` of its sentence.

Besides plain beam search: diverse beam groups, a ``SearchStrategy``
(lexical constraints, diverse siblings from ``diversity_rate``), sampling
(``sample_decode``: the same cache layout, an ancestry never permuted), the
int8 KV cache (plain PyTorch, ``layers.int8_cached_attention``) and
``retain_dropout`` (the model in training mode through the encoder and every
decode step, its masks drawn from a generator seeded by ``seed`` and the
call's number).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .beam_search import beam_search
from .sampling import sample_decode


@dataclass
class GeneratorSettings:
    """The JAX package's GeneratorSettings fields that the port reads (not
    its TPU cache options ``cache_segment`` and ``lazy_beam_reorder``: the
    port's caches are always the lazy-reorder layout of full length)."""

    beam_size: int = 5
    max_len_a: float = 0.0
    max_len_b: int = 200
    min_len: int = 1
    # per-sentence minimums a * src_len + b, enabled when either is set
    min_len_a: float = 0.0
    min_len_b: int = 0
    len_penalty: float = 1.0
    unk_penalty: float = 0.0
    max_decode_len: int = 256
    temperature: float = 1.0
    no_repeat_ngram_size: int = 0
    diverse_beam_groups: int = 0
    diverse_beam_strength: float = 0.5
    # diverse siblings (--diversity-rate); <= 0 is off
    diversity_rate: float = -1.0
    # sampling (--sampling, --sampling-topk / --sampling-topp); ``seed``
    # seeds the draws and the retained dropout's masks
    sampling: bool = False
    seed: int = 1
    sampling_topk: int = -1
    sampling_topp: float = -1.0
    kv_cache_int8: bool = False
    retain_dropout: bool = False


# generator settings whose feature is not ported yet, under the names the
# task's ``build_generator`` reads them by (the CLI's argument names):
# (attribute, test on its value, flag, ROADMAP item). None is left; the
# table stays for the next one.
UNPORTED = ()

# the non-autoregressive models' settings (``generation/nat_generator.py``):
# an autoregressive model's generator refuses them instead of ignoring them
NAT_ONLY = (
    ("iter_decode_max_iter", lambda v: v is not None, "--iter-decode-max-iter"),
    ("iter_decode_force_max_iter", bool, "--iter-decode-force-max-iter"),
    ("iter_decode_eos_penalty", lambda v: v != 0.0, "--iter-decode-eos-penalty"),
    ("iter_decode_with_beam", lambda v: v != 1, "--iter-decode-with-beam"),
    ("iter_decode_with_external_reranker", bool, "--iter-decode-with-external-reranker"),
    ("retain_iter_history", bool, "--retain-iter-history"),
    ("print_step", bool, "--print-step"),
)


def refuse_nat_settings(cfg) -> None:
    """Raises ValueError for the first NAT-only setting ``cfg`` sets."""
    for attr, is_set, flag in NAT_ONLY:
        if hasattr(cfg, attr) and is_set(getattr(cfg, attr)):
            raise ValueError(f"{flag} applies to the non-autoregressive models "
                             "(--task translation_lev / translation_ins)")


def require_ported(cfg, table=UNPORTED) -> None:
    """Raises for the first row of ``table`` that ``cfg`` sets. A field that
    ``cfg`` lacks is at its default, as ``build_generator`` reads it."""
    for attr, is_set, flag, item in table:
        if hasattr(cfg, attr) and is_set(getattr(cfg, attr)):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


def settings_from_cfg(g) -> GeneratorSettings:
    """GeneratorSettings from a generation config under the CLI's names
    (``beam``, ``lenpen``, ``unkpen``, ...); a missing field keeps its
    default."""
    return GeneratorSettings(
        beam_size=getattr(g, "beam", 5),
        max_len_a=getattr(g, "max_len_a", 0.0),
        max_len_b=getattr(g, "max_len_b", 200),
        min_len=getattr(g, "min_len", 1),
        min_len_a=getattr(g, "min_len_a", 0.0),
        min_len_b=getattr(g, "min_len_b", 0),
        len_penalty=getattr(g, "lenpen", 1.0),
        unk_penalty=getattr(g, "unkpen", 0.0),
        max_decode_len=getattr(g, "max_decode_len", 256),
        temperature=getattr(g, "temperature", 1.0),
        no_repeat_ngram_size=getattr(g, "no_repeat_ngram_size", 0),
        diverse_beam_groups=getattr(g, "diverse_beam_groups", 0),
        diverse_beam_strength=getattr(g, "diverse_beam_strength", 0.5),
        sampling=getattr(g, "sampling", False),
        seed=getattr(g, "seed", 1),
        sampling_topk=getattr(g, "sampling_topk", -1),
        sampling_topp=getattr(g, "sampling_topp", -1.0),
        diversity_rate=getattr(g, "diversity_rate", -1.0),
        kv_cache_int8=getattr(g, "kv_cache_int8", False),
        retain_dropout=getattr(g, "retain_dropout", False),
    )


def seeded_generator(seed: int, call: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one call: seeded by (seed, call number,
    stream), so that a call's draws do not depend on earlier calls."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) << 24) + (int(call) << 2) + stream)


def max_lens_from_settings(s: GeneratorSettings, src_lengths: torch.Tensor) -> torch.Tensor:
    """Per-sentence max real tokens a * src_len + b, clamped to the decode
    buffer minus the eos slot."""
    ml = (s.max_len_a * src_lengths + s.max_len_b).to(torch.int32)
    return torch.clamp(ml, max=s.max_decode_len - 1)


def min_lens_from_settings(s: GeneratorSettings, src_lengths: torch.Tensor
                           ) -> Optional[torch.Tensor]:
    """Per-sentence minimum lengths a * src_len + b, or None when unset."""
    if s.min_len_a == 0.0 and s.min_len_b == 0:
        return None
    ml = (s.min_len_a * src_lengths + s.min_len_b).to(torch.int32)
    return torch.clamp(ml, max=s.max_decode_len - 1)


def lazy_reorder(B: int, K: int, L: int, device):
    """The identity ancestry map [L + 1, B*K] (one row past the last step,
    so the row-(i+1) reset never clips) and the beam search's ``reorder_fn``
    that permutes it: the caches themselves never move."""
    iota_cols = torch.arange(K, dtype=torch.int32, device=device).repeat(B)
    ancestry = iota_cols[None, :].repeat(L + 1, 1).contiguous()
    sentence_base = torch.arange(B, device=device)[:, None] * K

    def reorder_fn(anc, picked_beam, index):
        anc = anc[:, (sentence_base + picked_beam).reshape(-1)]
        anc[index + 1] = iota_cols
        return anc.contiguous()

    return ancestry, reorder_fn


@contextlib.contextmanager
def dropout_mode(model: torch.nn.Module, on: bool):
    """While open, ``model`` is in training mode if ``on`` (its dropouts
    act), then back in the mode it had."""
    was_training = model.training
    if on:
        model.train()
    try:
        yield
    finally:
        model.train(was_training)


class SequenceGenerator:
    """Beam search over any speech model with ``encode_audio(source,
    padding_mask) -> (encoder_out, encoder_padding_mask)`` and a
    ``TransformerDecoder`` as ``.decoder``: the interlingua model (fixed
    memory bank, mask None) and the fbank S2T transformer (padded encoder
    states and their mask). ``generate_text`` needs the model's
    ``encode_text`` (the interlingua model's text branch)."""

    # the generate CLI forces reference prefixes (--prefix-size) only through
    # generators that say they implement it
    supports_prefix = True

    def __init__(self, model: torch.nn.Module, settings: GeneratorSettings,
                 pad: int = 1, eos: int = 2, unk: int = 3, bos: Optional[int] = None,
                 strategy=None):
        self.model = model
        self.s = s = settings
        self.pad, self.eos, self.unk = pad, eos, unk
        self.bos = eos if bos is None else bos
        if s.sampling:
            conflicts = [flag for flag, on in (
                ("--diversity-rate", s.diversity_rate > 0),
                ("--diverse-beam-groups", s.diverse_beam_groups > 0),
                ("--no-repeat-ngram-size", s.no_repeat_ngram_size > 0),
                (f"search strategy {type(strategy).__name__}", strategy is not None)) if on]
            if conflicts:
                raise ValueError("--sampling is mutually exclusive with: "
                                 + ", ".join(conflicts))
            if s.kv_cache_int8:
                raise NotImplementedError(
                    "--kv-cache-int8 is only supported on the default lazy-reorder beam "
                    "decode path; incompatible with --sampling")
        if s.diversity_rate > 0 and s.diverse_beam_groups > 0:
            raise ValueError("--diversity-rate (diverse siblings) and --diverse-beam-groups "
                             "are mutually exclusive search modes")
        if s.retain_dropout and not hasattr(getattr(model, "cfg", None), "dropout"):
            raise NotImplementedError(
                f"--retain-dropout is not ported for {type(model).__name__}, whose config "
                "has no dropout field (ROADMAP A14)")
        if strategy is None and s.diversity_rate > 0:
            from .search_strategies import DiverseSiblingsSearch

            strategy = DiverseSiblingsSearch(s.diversity_rate)
        self.strategy = strategy
        self._call_count = 0

    @torch.inference_mode()
    def generate_from_encoder(self, encoder_out: torch.Tensor,
                              encoder_padding_mask: Optional[torch.Tensor],
                              max_lens: Optional[torch.Tensor] = None,
                              min_lens: Optional[torch.Tensor] = None,
                              prefix_tokens: Optional[torch.Tensor] = None,
                              dropout_generator: Optional[torch.Generator] = None,
                              sample_generator: Optional[torch.Generator] = None):
        """Beam search (or sampling) from the encoder's output ->
        (tokens [B, K, max_decode_len], scores [B, K], lengths [B, K]).
        ``dropout_generator`` drives the decoder's dropouts when the model is
        in training mode; ``sample_generator`` the sampling draws."""
        decoder = self.model.decoder
        B, K, L = encoder_out.shape[0], self.s.beam_size, self.s.max_decode_len
        device = encoder_out.device
        enc_kv = decoder.precompute_encoder_kv(encoder_out)
        kv_caches = decoder.init_cache(B * K, L, int8=self.s.kv_cache_int8)
        ancestry, reorder_fn = lazy_reorder(B, K, L, device)
        # the JAX step drops cross-attention probabilities where its encoder
        # K/V is not grouped: at beam 1 and in sampling's repeated layout
        cross_attention_dropout = K == 1 or self.s.sampling

        def step_fn(tokens, index, anc):
            logits = decoder.step(tokens, index, kv_caches, enc_kv, encoder_padding_mask, anc, K,
                                  dropout_generator, cross_attention_dropout)
            if self.s.temperature != 1.0:
                logits = logits / self.s.temperature
            return torch.log_softmax(logits, dim=-1), anc

        if self.s.sampling:
            if prefix_tokens is not None:
                raise NotImplementedError("--prefix-size with --sampling is not supported "
                                          "(prefix forcing is a beam-decode feature)")
            if sample_generator is None:
                raise ValueError("sampling needs sample_generator (seeded_generator(seed, "
                                 "call, device))")
            # the samples never swap columns: the ancestry stays the identity
            return sample_decode(
                step_fn, ancestry, batch_size=B, num_samples=K, max_len=L, eos=self.eos,
                pad=self.pad, generator=sample_generator, device=device, bos=self.bos,
                top_k=max(self.s.sampling_topk, 0), top_p=max(self.s.sampling_topp, 0.0),
                min_len=self.s.min_len, max_lens=max_lens, min_lens=min_lens,
                len_penalty=self.s.len_penalty, unk=self.unk, unk_penalty=self.s.unk_penalty)

        return beam_search(
            step_fn, ancestry, batch_size=B, beam_size=K, max_len=L, eos=self.eos, pad=self.pad,
            reorder_fn=reorder_fn, device=device, bos=self.bos, min_len=self.s.min_len,
            len_penalty=self.s.len_penalty, unk=self.unk, unk_penalty=self.s.unk_penalty,
            max_lens=max_lens, min_lens=min_lens, prefix_tokens=prefix_tokens,
            no_repeat_ngram_size=self.s.no_repeat_ngram_size,
            diverse_beam_groups=self.s.diverse_beam_groups,
            diverse_beam_strength=self.s.diverse_beam_strength, strategy=self.strategy,
        )

    def _generate(self, encode, src_lengths, prefix_tokens, device):
        """Encodes (``encode(generator)``) and decodes one batch; with
        ``retain_dropout`` both in training mode."""
        self._call_count += 1
        gens = {}
        if self.s.sampling:
            gens["sample_generator"] = seeded_generator(self.s.seed, self._call_count, device)
        with dropout_mode(self.model, self.s.retain_dropout):
            if self.s.retain_dropout:
                gens["dropout_generator"] = seeded_generator(self.s.seed, self._call_count,
                                                             device, stream=1)
                enc, enc_mask = encode(gens["dropout_generator"])
            else:
                enc, enc_mask = encode(None)
            max_lens = min_lens = None
            if src_lengths is not None:
                max_lens = max_lens_from_settings(self.s, src_lengths)
                min_lens = min_lens_from_settings(self.s, src_lengths)
            return self.generate_from_encoder(enc, enc_mask, max_lens, min_lens, prefix_tokens,
                                              **gens)

    @torch.inference_mode()
    def generate_audio(self, source: torch.Tensor, padding_mask: torch.Tensor,
                       src_lengths: Optional[torch.Tensor] = None,
                       prefix_tokens: Optional[torch.Tensor] = None):
        """source [B, T] waveform, padding_mask [B, T] True = pad ->
        (tokens [B, K, max_decode_len], scores [B, K], lengths [B, K])."""
        def encode(generator):
            if generator is None:
                return self.model.encode_audio(source, padding_mask)
            return self.model.encode_audio(source, padding_mask, generator)

        return self._generate(encode, src_lengths, prefix_tokens, source.device)

    @torch.inference_mode()
    def generate_text(self, src_tokens: torch.Tensor,
                      src_lengths: Optional[torch.Tensor] = None,
                      prefix_tokens: Optional[torch.Tensor] = None):
        """src_tokens [B, T] int, pad = the model's padding index -> as
        ``generate_audio``."""
        def encode(generator):
            if generator is None:
                return self.model.encode_text(src_tokens)
            return self.model.encode_text(src_tokens, generator)

        return self._generate(encode, src_lengths, prefix_tokens, src_tokens.device)

    @staticmethod
    def to_hypotheses(tokens, scores, lens, nbest: int = 1) -> List[List[Dict[str, Any]]]:
        """Host side: [B, K, L] results -> fairseq-style hypothesis dicts."""
        tokens, scores, lens = (np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t)
                                for t in (tokens, scores, lens))
        out = []
        for b in range(tokens.shape[0]):
            hyps = []
            for k in range(min(nbest, tokens.shape[1])):
                n = int(lens[b, k])
                hyps.append({"tokens": tokens[b, k, :n], "score": float(scores[b, k])})
            out.append(hyps)
        return out
