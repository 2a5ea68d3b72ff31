"""Levenshtein transformer (counterpart of
chimera_st_tpu/models/nat_levenshtein.py; fairseq
``levenshtein_transformer``, Gu et al. 2019): a refinement round deletes
tokens, inserts placeholders between adjacent tokens and fills them, each
stage one pass of the bidirectional decoder (K1 in every layer on the
card, three passes a round).

The canvases keep the JAX package's static ``[B, L]`` shape from round to
round: ``apply_del_words`` compacts the kept tokens with a stable sort and
``apply_ins_placeholders`` writes into a canvas of the same width, its
cumulative insertions capped at the width (fairseq reallocates shorter or
longer tensors instead).

Early exit: the JAX ``lax.while_loop`` stops once no canvas changed in a
round. Here the host reads "did any canvas change" once a round (one
device-to-host sync a round) and stops there; a round on a finished canvas
changes nothing, so the tokens and every sentence's step count are those
of the full bound. ``force_iterations`` runs every round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

from .layers import linear
from .nat_cmlm import NATDecoderMixin, cmlm_base, nat_backbone
from .transformer_mt import TransformerMTConfig, _config


@dataclass(frozen=True)
class LevenshteinConfig(TransformerMTConfig):
    max_ins: int = 64  # insertion-count classifier arity (reference: 256)


def apply_del_words(tokens: torch.Tensor, del_pred: torch.Tensor, pad: int = 1, bos: int = 0,
                    eos: int = 2) -> torch.Tensor:
    """Deletes the flagged tokens, compacting left within the width; pads
    count as deleted, bos and eos are never deleted."""
    L = tokens.shape[1]
    delete = torch.where(tokens != pad, del_pred, True)
    delete = torch.where((tokens == bos) | (tokens == eos), False, delete)
    order = torch.sort(delete.to(torch.int32), dim=1, stable=True).indices
    out = tokens.gather(1, order)
    nkeep = (~delete).sum(dim=1)
    pos = torch.arange(L, device=tokens.device)[None, :]
    return torch.where(pos < nkeep[:, None], out, pad)


def apply_ins_placeholders(tokens: torch.Tensor, ins_pred: torch.Tensor, pad: int = 1,
                           unk: int = 3, eos: int = 2) -> torch.Tensor:
    """Inserts ``ins_pred[b, i]`` placeholders (unk) between positions i and
    i + 1, within the width: the cumulative insertions are capped so that
    the result fits. Pad inputs are written as eos at the eos's slot, so
    colliding writes carry the same value."""
    L = tokens.shape[1]
    in_masks = tokens != pad
    in_len = in_masks.sum(dim=1)
    toks = torch.where(in_masks, tokens, eos)
    ins = torch.where(in_masks[:, 1:], ins_pred, 0).long()
    c = torch.minimum(torch.cumsum(ins, dim=1), torch.clamp(L - in_len, min=0)[:, None])
    ins = torch.cat([c[:, :1], c[:, 1:] - c[:, :-1]], dim=1)
    out_len = in_len + c[:, -1]
    pos = torch.arange(L, device=tokens.device)[None, :]
    out = torch.where(pos < out_len[:, None], unk, pad).to(tokens.dtype)
    out[:, 0] = toks[:, 0]
    reordering = torch.clamp(torch.cumsum(ins + in_masks[:, 1:].long(), dim=1), max=L - 1)
    return out.scatter(1, reordering, toks[:, 1:])


def refine_rounds(one_round: Callable, init_tokens: torch.Tensor, iterations: int,
                  force: bool = False, return_history: bool = False):
    """Runs ``one_round(tokens) -> (new tokens, whether the round made
    progress)`` up to ``iterations`` times, stopping after the first round
    without progress unless ``force`` (the JAX while loop; progress is read
    on the host once a round). -> (tokens, history [iterations, B, L] or
    None, each sentence's step count [B]: the rounds that changed its canvas
    before the first that did not, as JAX's ``_scan_refine_history``
    counts), and the number of rounds run as ``rounds``. The rounds are
    deterministic, so a history past the last round run repeats its
    canvas, as the JAX scan's would."""
    tokens = init_tokens
    B = tokens.shape[0]
    steps = torch.zeros(B, dtype=torch.int32, device=tokens.device)
    done = torch.zeros(B, dtype=torch.bool, device=tokens.device)
    hist = []
    rounds = 0
    while rounds < iterations:
        new, progress = one_round(tokens)
        changed = (new != tokens).any(dim=1)
        steps = torch.where(done, steps, steps + changed.to(torch.int32))
        done = done | ~changed
        tokens = new
        hist.append(new)
        rounds += 1
        if not force and not bool(progress):  # the one host read a round
            break
    history = None
    if return_history:
        history = torch.stack(hist + [tokens] * (iterations - rounds))
    return tokens, history, steps, rounds


class LevenshteinTransformer(NATDecoderMixin, nn.Module):
    def __init__(self, cfg: LevenshteinConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.backbone = nat_backbone(cfg, device)
        C = cfg.decoder_embed_dim
        self.mask_ins_head = linear(2 * C, cfg.max_ins, device=device)
        self.word_del_head = linear(C, 2, device=device)

    def forward_mask_ins(self, tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        """[B, L-1, max_ins] fp32 insertion-count logits per adjacent slot."""
        f = self.features(tokens, enc, enc_mask, generator)
        return self.mask_ins_head(torch.cat([f[:, :-1], f[:, 1:]], dim=-1)).float()

    def forward_word_ins(self, tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        """[B, L, V] fp32 token logits."""
        return self.decode_tokens(tokens, enc, enc_mask, generator).float()

    def forward_word_del(self, tokens, enc, enc_mask, generator=None) -> torch.Tensor:
        """[B, L, 2] fp32 keep / delete logits."""
        return self.word_del_head(self.features(tokens, enc, enc_mask, generator)).float()

    def forward(self, src_tokens, ins_input, masked_tgt, del_input, generator=None):
        """Training forward -> (ins_logits, word_logits, del_logits)."""
        enc, enc_mask = self.encode(src_tokens, generator)
        return (self.forward_mask_ins(ins_input, enc, enc_mask, generator),
                self.forward_word_ins(masked_tgt, enc, enc_mask, generator),
                self.forward_word_del(del_input, enc, enc_mask, generator))

    def refine(self, src_tokens: torch.Tensor, iterations: int = 6, max_len: int = 64,
               pad: int = 1, bos: int = 0, eos: int = 2, unk: int = 3,
               eos_penalty: float = 0.0, force_iterations: bool = False,
               return_history: bool = False):
        """Refinement from ``[bos, eos]`` canvases -> (tokens [B, L],
        lengths [B]); with ``return_history`` also the canvas after every
        round [iterations, B, L] and each sentence's step count [B].
        ``eos_penalty`` is subtracted from the zero-insertion logit
        (``--iter-decode-eos-penalty``); ``force_iterations`` disables the
        early exit (``--iter-decode-force-max-iter``)."""
        enc, enc_mask = self.encode(src_tokens)
        heads = lambda method, tokens: method(self, tokens, enc, enc_mask)  # noqa: E731
        return refine_levenshtein(self, heads, src_tokens.shape[0], iterations, max_len, pad,
                                  bos, eos, unk, eos_penalty, force_iterations, return_history,
                                  src_tokens.device)


def initial_canvas(B: int, L: int, pad: int, bos: int, eos: int, device) -> torch.Tensor:
    tokens = torch.full((B, L), pad, dtype=torch.long, device=device)
    tokens[:, 0], tokens[:, 1] = bos, eos
    return tokens


def refine_levenshtein(model, heads: Callable, B: int, iterations: int, max_len: int, pad: int,
                       bos: int, eos: int, unk: int, eos_penalty: float, force: bool,
                       return_history: bool, device) -> Tuple[torch.Tensor, ...]:
    """The refinement loop of one model or of an ensemble: ``heads(method,
    tokens)`` gives a stage's scores (a model's logits, an ensemble's
    averaged log-probabilities) for ``method`` of ``model``'s class; the eos
    penalty is subtracted from those scores."""
    cls = type(model)

    def one_round(tokens):
        del_pred = heads(cls.forward_word_del, tokens).argmax(dim=-1) == 1
        canvas = apply_del_words(tokens, del_pred, pad, bos, eos)
        ins_scores = heads(cls.forward_mask_ins, canvas)
        if eos_penalty > 0.0:
            ins_scores = ins_scores.clone()
            ins_scores[..., 0] -= eos_penalty
        canvas = apply_ins_placeholders(canvas, ins_scores.argmax(dim=-1), pad, unk, eos)
        pred = heads(cls.forward_word_ins, canvas).argmax(dim=-1)
        new = torch.where(canvas == unk, pred, canvas)
        return new, (new != tokens).any()

    tokens, hist, steps, _ = refine_rounds(
        one_round, initial_canvas(B, max_len, pad, bos, eos, device), iterations, force,
        return_history)
    lengths = (tokens != pad).sum(dim=1)
    if return_history:
        return tokens, lengths, hist, steps
    return tokens, lengths


def build_levenshtein(cfg_dict: Dict, device="cuda") -> LevenshteinTransformer:
    return LevenshteinTransformer(_config(LevenshteinConfig, cfg_dict), device=device)


def levenshtein_vaswani_big(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_embed_dim", 1024)
    d.setdefault("encoder_ffn_dim", 4096)
    d.setdefault("encoder_heads", 16)
    d.setdefault("decoder_heads", 16)  # the reference pins decoder_attention_heads=16
    d.setdefault("dropout", 0.3)
    return cmlm_base(d)


def levenshtein_big_t2t(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_normalize_before", True)
    d.setdefault("decoder_normalize_before", True)
    d.setdefault("attention_dropout", 0.1)
    d.setdefault("activation_dropout", 0.1)
    return levenshtein_vaswani_big(d)


# arch name -> (model name, preset) (reference nat/levenshtein_transformer.py:471-502);
# the base preset is CMLM's (the same widths)
ARCHITECTURES = {
    "levenshtein_transformer": ("levenshtein_transformer", cmlm_base),
    "levenshtein_transformer_wmt_en_de": ("levenshtein_transformer", cmlm_base),
    "levenshtein_transformer_vaswani_wmt_en_de_big": ("levenshtein_transformer",
                                                      levenshtein_vaswani_big),
    "levenshtein_transformer_wmt_en_de_big": ("levenshtein_transformer", levenshtein_big_t2t),
}
