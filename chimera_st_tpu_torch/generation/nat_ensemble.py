"""Ensemble refinement for the Levenshtein transformer (counterpart of
chimera_st_tpu/generation/nat_ensemble.py; fairseq ``EnsembleLevT``): each
stage of a round (deletion, placeholders, words) averages the members'
probabilities, logsumexp over their stacked log-softmaxes minus log n,
before its argmax; ``--iter-decode-eos-penalty`` acts on the averaged
scores. Every other non-autoregressive model refuses an ensemble, as in
JAX (fairseq's ``BasicEnsembleModel``)."""

from __future__ import annotations

import math

import torch

from ..models.nat_levenshtein import LevenshteinTransformer, refine_levenshtein
from .nat_generator import is_nat


def ensemble_refine(models, src_tokens: torch.Tensor, iterations: int = 6, max_len: int = 64,
                    pad: int = 1, bos: int = 0, eos: int = 2, unk: int = 3,
                    eos_penalty: float = 0.0, force_iterations: bool = False):
    """``LevenshteinTransformer.refine`` with every stage's scores the
    members' averaged log-probabilities -> (tokens [B, L], lengths [B])."""
    encs = [m.encode(src_tokens) for m in models]

    def heads(method, tokens):
        lps = [torch.log_softmax(method(m, tokens, enc, enc_mask), dim=-1)
               for m, (enc, enc_mask) in zip(models, encs)]
        if len(lps) == 1:
            return lps[0]
        return torch.logsumexp(torch.stack(lps), dim=0) - math.log(len(lps))

    return refine_levenshtein(models[0], heads, src_tokens.shape[0], iterations, max_len, pad,
                              bos, eos, unk, eos_penalty, force_iterations, False,
                              src_tokens.device)


def build_nat_ensemble_generator(models, gen_cfg, tgt_dict):
    """A one-hypothesis generator over ``ensemble_refine``, or None when the
    lead model is not a NAT model."""
    model = models[0]
    if not is_nat(model):
        return None
    if not isinstance(model, LevenshteinTransformer):
        raise NotImplementedError(
            "ensemble decoding is only supported for levenshtein_transformer among the NAT "
            "families (reference: nonautoregressive_ensembles.py)")
    if not all(isinstance(m, LevenshteinTransformer) for m in models):
        raise NotImplementedError("all ensemble members must be Levenshtein models")
    if getattr(gen_cfg, "retain_iter_history", False) or getattr(gen_cfg, "print_step", False):
        raise NotImplementedError("--retain-iter-history/--print-step are not supported for NAT "
                                  "ensemble decoding; use a single checkpoint")
    req_iters = getattr(gen_cfg, "iter_decode_max_iter", None)
    settings = dict(
        iterations=req_iters if req_iters is not None else 6,
        max_len=min(getattr(gen_cfg, "max_decode_len", 64) or 64, 256),
        pad=tgt_dict.pad(), bos=tgt_dict.bos(), eos=tgt_dict.eos(), unk=tgt_dict.unk(),
        eos_penalty=float(getattr(gen_cfg, "iter_decode_eos_penalty", 0.0) or 0.0),
        force_iterations=bool(getattr(gen_cfg, "iter_decode_force_max_iter", False)))

    class NATEnsembleGenerator:
        supports_prefix = False

        @torch.inference_mode()
        def generate_text(self, src_tokens, src_lengths=None):
            tokens, lengths = ensemble_refine(models, src_tokens, **settings)
            tokens, lengths = tokens[:, 1:], torch.clamp(lengths - 1, min=1)  # drop bos
            return (tokens[:, None, :], torch.zeros(tokens.shape[0], 1, device=tokens.device),
                    lengths[:, None])

    return NATEnsembleGenerator()
