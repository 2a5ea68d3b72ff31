"""Sequence generator for speech translation, lazy-reorder beam search
(counterpart of chimera_st_tpu/generation/generator.py).

The encoder runs once per batch. The cross-attention K/V of every decoder
layer is projected once per sentence and stays UN-repeated [B, S, H, D]:
the beams of a sentence share it. The self-attention caches
[B*K, H, max_decode_len, D] are preallocated and written in place; the beam
search never permutes them. Instead an ancestry map [max_decode_len + 1,
B*K] is permuted (``reorder_fn``), and the attention kernel reads each
hypothesis's time-l entry from column ``ancestry[l, hyp]`` of its sentence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .beam_search import beam_search


@dataclass
class GeneratorSettings:
    """The JAX package's GeneratorSettings fields that the default beam path
    reads (sampling, diverse beams and the TPU cache options are left
    out)."""

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


# generator settings whose feature is not ported yet, under the names the
# task's ``build_generator`` reads them by (the CLI's argument names):
# (attribute, test on its value, flag, ROADMAP item)
UNPORTED = (
    ("sampling", bool, "--sampling", "A13"),
    ("sampling_topk", lambda v: v > 0, "--sampling-topk", "A13"),
    ("sampling_topp", lambda v: v > 0, "--sampling-topp", "A13"),
    ("diverse_beam_groups", lambda v: v > 1, "--diverse-beam-groups", "A13"),
    ("diversity_rate", lambda v: v > 0, "--diversity-rate", "A13"),
    ("path", lambda v: v is not None and ":" in v, "--path with several checkpoints", "A13"),
    ("lm_path", bool, "--lm-path", "A13"),
    ("ctc_lm_path", bool, "--ctc-lm-path", "A13"),
    ("score_reference", bool, "--score-reference", "A13"),
    ("print_alignment", bool, "--print-alignment", "A13"),
    ("replace_unk", lambda v: v is not None, "--replace-unk", "A13"),
    ("kv_cache_int8", bool, "--kv-cache-int8", "A13"),
    ("retain_dropout", bool, "--retain-dropout", "A13"),
    ("iter_decode_max_iter", lambda v: v is not None, "--iter-decode-max-iter", "A13"),
    ("iter_decode_force_max_iter", bool, "--iter-decode-force-max-iter", "A13"),
    ("iter_decode_eos_penalty", lambda v: v != 0.0, "--iter-decode-eos-penalty", "A13"),
    ("iter_decode_with_beam", lambda v: v != 1, "--iter-decode-with-beam", "A13"),
    ("iter_decode_with_external_reranker", bool, "--iter-decode-with-external-reranker", "A13"),
    ("retain_iter_history", bool, "--retain-iter-history", "A13"),
    ("print_step", bool, "--print-step", "A13"),
    ("constraints", bool, "--constraints", "A13"),
)


def require_ported(cfg, table=UNPORTED) -> None:
    """Raises for the first row of ``table`` that ``cfg`` sets. A field that
    ``cfg`` lacks is at its default, as ``build_generator`` reads it."""
    for attr, is_set, flag, item in table:
        if hasattr(cfg, attr) and is_set(getattr(cfg, attr)):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


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
                 pad: int = 1, eos: int = 2, unk: int = 3, bos: Optional[int] = None):
        self.model = model
        self.s = settings
        self.pad, self.eos, self.unk = pad, eos, unk
        self.bos = eos if bos is None else bos

    def max_lens_for_src(self, src_lengths: torch.Tensor) -> torch.Tensor:
        """Per-sentence max real tokens a * src_len + b, clamped to the decode
        buffer minus the eos slot."""
        ml = (self.s.max_len_a * src_lengths + self.s.max_len_b).to(torch.int32)
        return torch.clamp(ml, max=self.s.max_decode_len - 1)

    def min_lens_for_src(self, src_lengths: torch.Tensor) -> Optional[torch.Tensor]:
        if self.s.min_len_a == 0.0 and self.s.min_len_b == 0:
            return None
        ml = (self.s.min_len_a * src_lengths + self.s.min_len_b).to(torch.int32)
        return torch.clamp(ml, max=self.s.max_decode_len - 1)

    @torch.inference_mode()
    def generate_from_encoder(self, encoder_out: torch.Tensor,
                              encoder_padding_mask: Optional[torch.Tensor],
                              max_lens: Optional[torch.Tensor] = None,
                              min_lens: Optional[torch.Tensor] = None,
                              prefix_tokens: Optional[torch.Tensor] = None):
        decoder = self.model.decoder
        B, K, L = encoder_out.shape[0], self.s.beam_size, self.s.max_decode_len
        device = encoder_out.device
        enc_kv = decoder.precompute_encoder_kv(encoder_out)
        kv_caches = decoder.init_cache(B * K, L)
        iota_cols = torch.arange(K, dtype=torch.int32, device=device).repeat(B)
        # one row past the last step, so the row-(i+1) reset never clips
        ancestry = iota_cols[None, :].repeat(L + 1, 1).contiguous()
        sentence_base = torch.arange(B, device=device)[:, None] * K

        def step_fn(tokens, index, anc):
            logits = decoder.step(tokens, index, kv_caches, enc_kv, encoder_padding_mask, anc, K)
            if self.s.temperature != 1.0:
                logits = logits / self.s.temperature
            return torch.log_softmax(logits, dim=-1), anc

        def reorder_fn(anc, picked_beam, index):
            anc = anc[:, (sentence_base + picked_beam).reshape(-1)]
            anc[index + 1] = iota_cols
            return anc.contiguous()

        return beam_search(
            step_fn, ancestry, batch_size=B, beam_size=K, max_len=L, eos=self.eos, pad=self.pad,
            reorder_fn=reorder_fn, device=device, bos=self.bos, min_len=self.s.min_len,
            len_penalty=self.s.len_penalty, unk=self.unk, unk_penalty=self.s.unk_penalty,
            max_lens=max_lens, min_lens=min_lens, prefix_tokens=prefix_tokens,
            no_repeat_ngram_size=self.s.no_repeat_ngram_size,
        )

    def _generate(self, enc, enc_mask, src_lengths, prefix_tokens):
        max_lens = min_lens = None
        if src_lengths is not None:
            max_lens = self.max_lens_for_src(src_lengths)
            min_lens = self.min_lens_for_src(src_lengths)
        return self.generate_from_encoder(enc, enc_mask, max_lens, min_lens, prefix_tokens)

    @torch.inference_mode()
    def generate_audio(self, source: torch.Tensor, padding_mask: torch.Tensor,
                       src_lengths: Optional[torch.Tensor] = None,
                       prefix_tokens: Optional[torch.Tensor] = None):
        """source [B, T] waveform, padding_mask [B, T] True = pad ->
        (tokens [B, K, max_decode_len], scores [B, K], lengths [B, K])."""
        enc, enc_mask = self.model.encode_audio(source, padding_mask)
        return self._generate(enc, enc_mask, src_lengths, prefix_tokens)

    @torch.inference_mode()
    def generate_text(self, src_tokens: torch.Tensor,
                      src_lengths: Optional[torch.Tensor] = None,
                      prefix_tokens: Optional[torch.Tensor] = None):
        """src_tokens [B, T] int, pad = the model's padding index -> as
        ``generate_audio``."""
        enc, enc_mask = self.model.encode_text(src_tokens)
        return self._generate(enc, enc_mask, src_lengths, prefix_tokens)

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
