"""Ensemble beam search with optional language-model shallow fusion
(counterpart of chimera_st_tpu/generation/ensemble.py; reference
fairseq/sequence_generator.py EnsembleModel and fairseq_cli/generate.py
``--lm-path``): each step emits log(mean_i p_i), the probability-space
average of the models' tempered distributions, plus ``lm_weight`` times the
language model's normalized log-probabilities (the LM untempered, as in the
JAX package): the log_softmax of its output layer, or, for an LM with an
adaptive softmax (``transformer_lm_wiki103``), the adaptive softmax's
(``TransformerLM.step_log_probs``). Here the port diverges from the JAX
package, whose fusion log-softmaxes the decoder's tied full-vocabulary
projection and so ignores a trained adaptive softmax (ROADMAP C).

Each model, and the language model, keeps its own self-attention caches in
the lazy-reorder layout of ``SequenceGenerator``, with one ancestry map for
all of them: the beam search reorders the hypotheses of every model
together, so one permutation of the map is the gather of every model's
caches. Each decoder layer of each model, and each layer of the language
model, launches K3 once a step. Plain beam search only: the int8 cache,
sampling, diverse beams and retained dropout are single-model features here
as in the JAX package. A single model with a language model decodes here
too, as the JAX CLI does it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from .beam_search import beam_search
from .generator import (
    GeneratorSettings,
    lazy_reorder,
    max_lens_from_settings,
    min_lens_from_settings,
)


class EnsembleSequenceGenerator:
    def __init__(self, models: List[torch.nn.Module], settings: GeneratorSettings,
                 pad: int = 1, eos: int = 2, unk: int = 3, lm=None):
        """``lm``: (a ``TransformerLM`` on the models' device and target
        dictionary, its weight), or None."""
        if not models:
            raise ValueError("an ensemble needs at least one model")
        if settings.kv_cache_int8:
            raise NotImplementedError("--kv-cache-int8 is a single-model decode feature; "
                                      "ensemble decoding allocates full-precision caches")
        for flag, on in (("--sampling", settings.sampling),
                         ("--diverse-beam-groups", settings.diverse_beam_groups > 0),
                         ("--diversity-rate", settings.diversity_rate >= 0),
                         ("--retain-dropout", settings.retain_dropout)):
            if on:
                raise NotImplementedError(f"ensemble decoding supports plain beam search only; "
                                          f"{flag} is a single-model feature")
        self.models = models
        self.s = settings
        self.pad, self.eos, self.unk = pad, eos, unk
        self.lm = lm

    @torch.inference_mode()
    def generate_from_encoders(self, encoder_outs, max_lens: Optional[torch.Tensor] = None,
                               min_lens: Optional[torch.Tensor] = None):
        """encoder_outs: one (encoder_out [B, S, C], padding mask or None)
        per model -> (tokens [B, K, max_decode_len], scores [B, K],
        lengths [B, K])."""
        B, K, L = encoder_outs[0][0].shape[0], self.s.beam_size, self.s.max_decode_len
        device = encoder_outs[0][0].device
        per_model = []
        for model, (enc, enc_mask) in zip(self.models, encoder_outs):
            decoder = model.decoder
            per_model.append((decoder, decoder.precompute_encoder_kv(enc), enc_mask,
                              decoder.init_cache(B * K, L)))
        lm_caches = None
        if self.lm is not None:
            lm_caches = self.lm[0].decoder.init_cache(B * K, L)
        ancestry, reorder_fn = lazy_reorder(B, K, L, device)
        log_n = math.log(float(len(self.models)))

        def step_fn(tokens, index, anc):
            lps = []
            for decoder, enc_kv, enc_mask, caches in per_model:
                logits = decoder.step(tokens, index, caches, enc_kv, enc_mask, anc, K)
                if self.s.temperature != 1.0:
                    logits = logits / self.s.temperature
                lps.append(torch.log_softmax(logits.float(), dim=-1))
            if len(lps) == 1:
                avg = lps[0]
            else:
                avg = torch.logsumexp(torch.stack(lps), dim=0) - log_n
            if lm_caches is not None:
                lm, weight = self.lm
                avg = avg + weight * lm.step_log_probs(tokens, index, lm_caches, anc, K)
            return avg, anc

        return beam_search(
            step_fn, ancestry, batch_size=B, beam_size=K, max_len=L, eos=self.eos, pad=self.pad,
            reorder_fn=reorder_fn, device=device, min_len=self.s.min_len,
            len_penalty=self.s.len_penalty, unk=self.unk, unk_penalty=self.s.unk_penalty,
            max_lens=max_lens, min_lens=min_lens,
            no_repeat_ngram_size=self.s.no_repeat_ngram_size)

    def _lengths_for(self, src_lengths):
        if src_lengths is None:
            return None, None
        return (max_lens_from_settings(self.s, src_lengths),
                min_lens_from_settings(self.s, src_lengths))

    @torch.inference_mode()
    def generate_audio(self, source: torch.Tensor, padding_mask: torch.Tensor,
                       src_lengths: Optional[torch.Tensor] = None):
        encoder_outs = [m.encode_audio(source, padding_mask) for m in self.models]
        return self.generate_from_encoders(encoder_outs, *self._lengths_for(src_lengths))

    @torch.inference_mode()
    def generate_text(self, src_tokens: torch.Tensor,
                      src_lengths: Optional[torch.Tensor] = None):
        encoder_outs = [m.encode_text(src_tokens) for m in self.models]
        return self.generate_from_encoders(encoder_outs, *self._lengths_for(src_lengths))
