"""The reference's training step: the triplet loss (speech translation and
text translation, label-smoothed cross entropy, and the per-slot InfoNCE of
the two memory banks at temperature 0.1), gradients summed over the
micro-batches and divided by their target tokens, then Adam.

Dropout masks of micro-batch i of an update with seed s come from a card
generator seeded with the first 64-bit word of
``numpy.random.SeedSequence((s, i))``, the keying the program documents
for its training step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .nn import seeded_dropout

PAD = 1


def microbatch_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0])


def label_smoothed(logits: torch.Tensor, target: torch.Tensor, eps: float):
    lprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -lprobs.gather(-1, target[..., None])[..., 0]
    smooth = -lprobs.sum(dim=-1)
    keep = target != PAD
    nll, smooth = torch.where(keep, nll, 0.0).sum(), torch.where(keep, smooth, 0.0).sum()
    return (1.0 - eps) * nll + eps / lprobs.shape[-1] * smooth


def memory_infonce(audio_mem, text_mem, temperature: float):
    unit = lambda x: x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)
    logits = torch.einsum("bid,bjd->bij", unit(audio_mem), unit(text_mem)) / temperature
    return -torch.diagonal(torch.log_softmax(logits, dim=1), dim1=1, dim2=2).sum()


def triplet_loss(ref, mb: Dict[str, torch.Tensor], crit: Dict, drop) -> torch.Tensor:
    """The summed loss of one micro-batch: the audio pass, then the text
    pass, as the program runs them (their dropout sites in that order)."""
    eps = float(crit["label_smoothing"])
    r_st, r_mt, r_c = (float(r) for r in crit["loss_ratio"])
    audio_mem, mem_pad = ref.encode_audio(mb["audio"], mb["audio_padding_mask"], drop)
    loss = r_st * label_smoothed(ref.decode(mb["prev_output_tokens"], audio_mem, mem_pad, drop),
                                 mb["target"], eps)
    if r_mt or r_c:
        text_mem = ref.encode_text(mb["src_text"], drop)
        loss = loss + r_mt * label_smoothed(ref.decode(mb["prev_output_tokens"], text_mem, None,
                                                       drop), mb["target"], eps)
        if r_c:
            loss = loss + r_c * memory_infonce(audio_mem, text_mem,
                                               float(crit.get("contrastive_temp", 0.1)))
    return loss


class Adam:
    """torch's Adam update (no weight decay): m, v, bias corrections."""

    def __init__(self, params: Sequence[torch.Tensor], betas, eps: float):
        self.params = list(params)
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt() / bc2 ** 0.5 + self.eps, value=-lr / bc1)


def inverse_sqrt(count: int, lr: float, warmup: int) -> float:
    if count < warmup:
        return lr * count / max(warmup, 1)
    return lr * warmup ** 0.5 / max(count, 1) ** 0.5


def run_updates(ref, params: Dict[str, torch.Tensor], updates: List[List[Dict]],
                seeds: List[int], lrs: List[float], crit: Dict, betas, eps: float):
    """The updates, each a list of micro-batches, from the given weights
    (trained in place) -> per update its summed loss, and the first
    update's gradient norms (divided by its target tokens) by name."""
    names = sorted(params)
    opt = Adam([params[n] for n in names], betas, eps)
    losses, first_grads = [], None
    for u, (mbs, seed, lr) in enumerate(zip(updates, seeds, lrs)):
        for n in names:
            params[n].grad = None
        total, tokens = 0.0, 0.0
        for i, mb in enumerate(mbs):
            gen = torch.Generator(device=mb["audio"].device).manual_seed(microbatch_seed(seed, i))
            loss = triplet_loss(ref, mb, crit, seeded_dropout(gen))
            loss.backward()
            total += float(loss.detach())
            tokens += float(mb["ntokens"])
            del loss
        for n in names:
            if params[n].grad is None:
                params[n].grad = torch.zeros_like(params[n])
            params[n].grad.div_(max(tokens, 1.0))
        if u == 0:
            norms = torch.stack([torch.linalg.vector_norm(params[n].grad) for n in names])
            first_grads = dict(zip(names, norms.tolist()))
        opt.step(lr)
        losses.append(total)
    for n in names:
        params[n].grad = None
    return losses, first_grads
