"""The generate CLI's adapter for the non-autoregressive models (counterpart
of chimera_st_tpu/generation/nat_generator.py; fairseq
``iterative_refinement_generator``).

``build_nat_generator`` dispatches on the model's decode method:
``refine`` (Levenshtein, insertion), ``mask_predict`` (CMLM) or
``translate`` (vanilla / iterative NAT, NAT-CRF), and returns a generator
whose ``generate_text`` gives the beam generator's contract with one
hypothesis a sentence (tokens [B, 1, L], scores [B, 1], lengths [B, 1]),
or None for a model that is none of them. The canvases are ``[B, L]``,
``L = min(max_decode_len or 64, 256)``, as in JAX.

The flags, with the JAX guards and messages: ``--iter-decode-max-iter``
(defaults 6 Levenshtein, 8 insertion, 10 CMLM, 1 the translate family),
``--iter-decode-force-max-iter``, ``--iter-decode-eos-penalty``
(Levenshtein), ``--iter-decode-with-beam`` (models with a length head),
``--iter-decode-with-external-reranker`` (an autoregressive model
teacher-force scores every length-beam candidate: the mean log-probability
of its tokens after an eos, and the best wins), ``--retain-iter-history``
(``last_history`` [rounds, B, L], printed as E- lines) and ``--print-step``
(``last_steps`` [B], printed as I- lines).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


# generation settings of the beam search that a refinement decode has no use for
BEAM_ONLY = (("sampling", "--sampling"), ("diverse_beam_groups", "--diverse-beam-groups"),
             ("diversity_rate", "--diversity-rate"), ("kv_cache_int8", "--kv-cache-int8"),
             ("retain_dropout", "--retain-dropout"),
             ("no_repeat_ngram_size", "--no-repeat-ngram-size"))


def is_nat(model) -> bool:
    return any(hasattr(type(model), m) for m in ("refine", "mask_predict", "translate"))


def build_nat_generator(model, gen_cfg, tgt_dict, bos: Optional[int] = None,
                        unk: Optional[int] = None, reranker=None):
    """``reranker``: the autoregressive model of the last ``--path``, which
    ``--iter-decode-with-external-reranker`` needs."""
    cls = type(model)
    max_len = min(getattr(gen_cfg, "max_decode_len", 64) or 64, 256)
    pad, eos = tgt_dict.pad(), tgt_dict.eos()
    bos = tgt_dict.bos() if bos is None else bos
    unk = tgt_dict.unk() if unk is None else unk
    req_iters = getattr(gen_cfg, "iter_decode_max_iter", None)
    eos_penalty = float(getattr(gen_cfg, "iter_decode_eos_penalty", 0.0) or 0.0)
    force = bool(getattr(gen_cfg, "iter_decode_force_max_iter", False))
    length_beam = int(getattr(gen_cfg, "iter_decode_with_beam", 1) or 1)
    retain_history = bool(getattr(gen_cfg, "retain_iter_history", False))
    print_step = bool(getattr(gen_cfg, "print_step", False))
    reranking = bool(getattr(gen_cfg, "iter_decode_with_external_reranker", False))
    # --print-step on a single canvas rides the history-recording decode;
    # a length-beam decode runs every round, so its count is `iterations`
    record_history = retain_history or (print_step and length_beam <= 1)

    if not is_nat(model):
        if reranking:
            raise NotImplementedError(
                "--iter-decode-with-external-reranker only applies to NAT models (the "
                "reference's IterativeRefinementGenerator)")
        return None
    # the beam search's modes: refused rather than ignored
    for attr, flag in BEAM_ONLY:
        if (getattr(gen_cfg, attr, None) or 0) > 0:
            raise ValueError(f"{flag} applies to the beam search; the NAT models decode by "
                             "refinement")
    if reranking:
        if reranker is None:
            raise ValueError("--iter-decode-with-external-reranker needs at least two --path "
                             "checkpoints; the last one is the AR reranker")
        if length_beam <= 1:
            raise ValueError("--iter-decode-with-external-reranker requires "
                             "--iter-decode-with-beam > 1 (reranking needs multiple candidates "
                             "per sentence)")
    if retain_history and length_beam > 1:
        raise NotImplementedError("--retain-iter-history with --iter-decode-with-beam is not "
                                  "supported here (history is recorded for the single-canvas "
                                  "refinement)")

    strip_bos = True  # the canvases of refine and translate start with bos
    candidates = None
    if hasattr(cls, "refine"):
        iterations = req_iters if req_iters is not None else (
            8 if "Insertion" in cls.__name__ else 6)
        extra = dict(force_iterations=force)
        if "Levenshtein" in cls.__name__:
            extra["eos_penalty"] = eos_penalty
        elif eos_penalty:
            raise NotImplementedError("--iter-decode-eos-penalty only applies to "
                                      "levenshtein_transformer (its placeholder-insertion stage)")
        if length_beam > 1:
            raise NotImplementedError(
                f"--iter-decode-with-beam is not supported for {cls.__name__}; length-beam "
                f"needs a length-prediction head (vanilla/iterative NAT, NAT-CRF, CMLM)")

        def run(src, history):
            return model.refine(src, iterations=iterations, max_len=max_len, pad=pad, bos=bos,
                                eos=eos, unk=unk, return_history=history, **extra)
    elif hasattr(cls, "mask_predict"):
        iterations = req_iters if req_iters is not None else 10
        strip_bos = False  # a CMLM canvas holds no bos
        if length_beam > 1:
            def run(src, history):
                return model.mask_predict_with_length_beam(
                    src, beam=length_beam, iterations=iterations, max_len=max_len, pad=pad,
                    eos=eos)

            def candidates(src):
                return model.mask_predict_with_length_beam(
                    src, beam=length_beam, iterations=iterations, max_len=max_len, pad=pad,
                    eos=eos, return_candidates=True)
        else:
            def run(src, history):
                out = model.mask_predict(src, iterations=iterations, max_len=max_len, pad=pad,
                                         eos=eos, return_history=history)
                if not history:
                    return out
                # mask-predict has no early exit: every sentence runs every round
                return (*out, torch.full(out[0].shape[:1], iterations, dtype=torch.int32))
    else:
        iterations = req_iters if req_iters is not None else 1
        if length_beam > 1:
            def run(src, history):
                return model.translate_with_length_beam(src, beam=length_beam, max_len=max_len,
                                                        iterations=iterations)

            def candidates(src):
                return model.translate_with_length_beam(src, beam=length_beam, max_len=max_len,
                                                        iterations=iterations,
                                                        return_candidates=True)
        else:
            def run(src, history):
                out = model.translate(src, max_len=max_len, iterations=iterations,
                                      return_history=history)
                if not history:
                    return out
                return (*out, torch.full(out[0].shape[:1], iterations, dtype=torch.int32))

    def strip(tokens, lengths):
        """Drops the canvas's bos (its length at least 1)."""
        if not strip_bos:
            return tokens, lengths
        return tokens[:, 1:], torch.clamp(lengths - 1, min=1)

    return NATGenerator(run, candidates, strip, record_history, retain_history, print_step,
                        iterations, reranker if reranking else None, length_beam, pad, eos)


def rerank_scores(rr_model, src_tokens: torch.Tensor, cand: torch.Tensor, pad: int,
                  eos: int) -> torch.Tensor:
    """Each candidate's mean token log-probability under the autoregressive
    ``rr_model``, teacher-forced after an eos (the reference's rebuilt
    batch, whose position 0 becomes eos), over its non-pad tokens."""
    src_rep = torch.repeat_interleave(src_tokens, cand.shape[0] // src_tokens.shape[0], dim=0)
    led = torch.cat([torch.full_like(cand[:, :1], eos), cand], dim=1)[:, :-1]
    lp = torch.log_softmax(rr_model(src_rep, led).float(), dim=-1)
    tok_lp = lp.gather(-1, cand[..., None])[..., 0]
    mask = cand != pad
    return torch.where(mask, tok_lp, 0.0).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1)


class NATGenerator:
    """One hypothesis a sentence from a whole-canvas refinement decode.
    ``last_history`` / ``last_steps`` (numpy) hold the last batch's rounds
    [rounds, B, L] under ``--retain-iter-history`` and step counts [B]
    under ``--print-step`` (or None)."""

    supports_prefix = False

    def __init__(self, run, candidates, strip, record_history, retain_history, print_step,
                 iterations, reranker, length_beam, pad, eos):
        self.run, self.candidates, self.strip = run, candidates, strip
        self.record_history, self.retain_history = record_history, retain_history
        self.print_step, self.iterations = print_step, iterations
        self.reranker, self.length_beam = reranker, length_beam
        self.pad, self.eos = pad, eos
        self.last_history = self.last_steps = None

    @torch.inference_mode()
    def generate_text(self, src_tokens: torch.Tensor, src_lengths=None, prefix_tokens=None):
        if prefix_tokens is not None:
            raise NotImplementedError("--prefix-size is not supported for NAT decoding")
        B = src_tokens.shape[0]
        if self.print_step and not self.record_history:
            # a length-beam decode runs the full refinement schedule
            self.last_steps = np.full((B,), self.iterations, np.int32)
        if self.reranker is not None:
            cand, cand_lens = self.strip(*self.candidates(src_tokens)[:2])
            score = rerank_scores(self.reranker, src_tokens, cand, self.pad, self.eos)
            flat = (torch.arange(B, device=cand.device) * self.length_beam
                    + score.reshape(B, self.length_beam).argmax(dim=1))
            return cand[flat][:, None, :], score[flat][:, None], cand_lens[flat][:, None]
        if self.record_history:
            tokens, lens, hist, steps = self.run(src_tokens, True)
            tokens, lens = self.strip(tokens, lens)
            if self.retain_history:
                self.last_history = (hist[:, :, 1:] if tokens.shape[1] < hist.shape[2]
                                     else hist).cpu().numpy()
            self.last_steps = steps.cpu().numpy()
        else:
            tokens, lens = self.strip(*self.run(src_tokens, False))
        scores = torch.zeros(B, 1, device=tokens.device)
        return tokens[:, None, :], scores, lens[:, None]
