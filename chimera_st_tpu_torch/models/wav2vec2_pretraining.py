"""wav2vec 2.0 self-supervised pre-training (counterpart of
chimera_st_tpu/models/wav2vec2_pretraining.py): the host-side span-mask and
negative samplers, the Gumbel and k-means vector quantizers, and
``Wav2Vec2PretrainModel`` with Chimera's bimodal ("quasiwave") forward.

The JAX package's static-shape design is kept: predictions and targets are
computed at every frame, and the criterion weights the InfoNCE loss by the
mask. The negatives are gathered by index, ``targets[b, neg_idx[b, t, n]]``
into [B, T, N, D] (JAX broadcasts the targets to [B, T, T, D] first, which
in PyTorch would be GBs at a 15 s crop); a negative equal to the positive
over the whole vector gets -inf (``isclose``, as JAX). What the JAX
pre-training path leaves out stays out (ROADMAP C): no ``grad_multiply`` of
the extractor's output (fairseq's 0.1 is 1.0 here, so K2's backward sees
the full gradient), no input or feature dropout, no layerdrop; the trunk's
attention dropout is the JAX trunk's default 0.1 (the K1 forward is not on
a training micro-batch's path; evaluation runs it).

The Gumbel quantizer draws its uniform noise with ``uniform_noise`` from the
forward's ``generator`` (JAX draws it with ``jax.random``, whose bits cannot
be reproduced; a parity test hands both packages the same numbers).
Module names follow the JAX tree: the trunk ``wav2vec_model``, the model's
own ``mask_emb``, ``quantizer`` (``codebook`` / ``weight_proj``, or
``embedding`` / ``proj`` / ``group_norm``), ``project_q`` and
``final_proj``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv1d, linear
from .wav2vec2 import DEFAULT_CONV_SPEC, Wav2Vec2Encoder, downsample_padding_mask


def compute_mask_indices(shape: Tuple[int, int], padding_mask: Optional[np.ndarray],
                         mask_prob: float = 0.65, mask_length: int = 10, min_masks: int = 2,
                         rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Host-side span mask [B, T] bool (JAX ``wav2vec2_pretraining.py:34-58``,
    fairseq's "static" span policy), drawn call for call as the JAX code
    draws from ``rng``."""
    rng = rng or np.random.default_rng()
    B, T = shape
    mask = np.zeros((B, T), bool)
    for b in range(B):
        sz = T if padding_mask is None else int((~padding_mask[b]).sum())
        num_spans = int(mask_prob * sz / float(mask_length) + rng.random())
        num_spans = max(num_spans, min_masks)
        if sz <= mask_length:
            continue
        starts = rng.choice(sz - mask_length, size=num_spans, replace=True)
        for s in starts:
            mask[b, s: s + mask_length] = True
        if padding_mask is not None:
            mask[b] &= ~padding_mask[b]
    return mask


def sample_negative_indices(batch: int, frames: int, num_negatives: int,
                            padding_mask: Optional[np.ndarray] = None,
                            rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """[B, T, N] same-utterance negative indices that avoid the positive
    (JAX ``wav2vec2_pretraining.py:61-78``), drawn as the JAX code draws."""
    rng = rng or np.random.default_rng()
    out = np.zeros((batch, frames, num_negatives), np.int32)
    for b in range(batch):
        high = frames if padding_mask is None else max(int((~padding_mask[b]).sum()), 2)
        neg = rng.integers(0, high - 1, size=(frames, num_negatives))
        pos = np.arange(frames)[:, None]
        neg[neg >= np.minimum(pos, high - 1)] += 1
        out[b] = np.minimum(neg, high - 1)
    return out


def uniform_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The Gumbel quantizer's U[0, 1) draws, from the forward's generator."""
    if generator is None:
        raise ValueError("the Gumbel quantizer in training mode needs a torch.Generator")
    return torch.rand(shape, generator=generator, device=device)


def _perplexity(probs: torch.Tensor) -> torch.Tensor:
    """sum over groups of exp(entropy) of [G, V] distributions."""
    return torch.exp(-(probs * torch.log(probs + 1e-7)).sum(dim=-1)).sum()


class GumbelVectorQuantizer(nn.Module):
    """Straight-through Gumbel-softmax quantizer (JAX
    ``wav2vec2_pretraining.py:81-155``): argmax in evaluation."""

    def __init__(self, input_dim: int, num_vars: int = 320, groups: int = 2,
                 vq_dim: int = 256, device="cuda"):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"vq_dim {vq_dim} is not a multiple of groups {groups}")
        self.num_vars, self.groups, self.vq_dim = num_vars, groups, vq_dim
        self.var_dim = vq_dim // groups
        self.codebook = nn.Parameter(torch.zeros(1, groups * num_vars, self.var_dim,
                                                 device=device))
        self.weight_proj = linear(input_dim, groups * num_vars, device=device)

    def init_extra_(self, generator: torch.Generator) -> None:
        """flax's initialisers: codebook uniform in [0, 1), weight_proj
        normal(1.0) with zero bias."""
        self.codebook.uniform_(0.0, 1.0, generator=generator)
        self.weight_proj.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor, temperature: float = 2.0,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        logits = self.weight_proj(x).reshape(B * T * G, V).float()
        avg_probs = torch.softmax(logits.reshape(B * T, G, V), dim=-1).mean(dim=0)
        prob_ppl = _perplexity(avg_probs)
        if self.training:
            u = uniform_noise(logits.shape, generator, logits.device)
            gumbel = -torch.log(-torch.log(u + 1e-10) + 1e-10)
            probs = torch.softmax((logits + gumbel) / temperature, dim=-1)
            hard = F.one_hot(probs.argmax(dim=-1), V).float()
            assignment = hard + probs - probs.detach()  # straight-through
        else:
            assignment = F.one_hot(logits.argmax(dim=-1), V).float()
        cb = self.codebook.reshape(G, V, self.var_dim).float()
        q = torch.einsum("xgv,gvd->xgd", assignment.reshape(B * T, G, V), cb)
        return {"x": q.reshape(B, T, self.vq_dim), "prob_perplexity": prob_ppl,
                "num_vars": V * G, "temp": temperature}


class _GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on [B, T, C]: statistics over time and the
    channels of each group, epsilon 1e-6, a scale and bias a channel."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        xg = x.float().reshape(B, T, self.groups, C // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg.square().mean(dim=(1, 3), keepdim=True) - mean.square()).clamp(min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(B, T, C)
        return y * self.weight + self.bias


class KmeansVectorQuantizer(nn.Module):
    """Nearest-neighbour quantizer with a straight-through estimator and the
    latent + gamma * commitment loss (JAX ``wav2vec2_pretraining.py:158-251``;
    vq-wav2vec's k-means mode): a grouped pointwise projection, a group norm,
    then the nearest codeword of each group."""

    def __init__(self, input_dim: int, num_vars: int = 320, groups: int = 2,
                 vq_dim: int = 256, combine_groups: bool = False, gamma: float = 0.25,
                 device="cuda"):
        super().__init__()
        if vq_dim % groups or input_dim != vq_dim:
            raise ValueError("the k-means quantizer quantizes in the projected input space: "
                             "input_dim == vq_dim, a multiple of groups")
        self.num_vars, self.groups, self.vq_dim = num_vars, groups, vq_dim
        self.var_dim, self.combine_groups, self.gamma = vq_dim // groups, combine_groups, gamma
        self.embedding = nn.Parameter(torch.zeros(num_vars, 1 if combine_groups else groups,
                                                  self.var_dim, device=device))
        self.proj = conv1d(input_dim, input_dim, 1, groups=groups, bias=False, device=device)
        self.group_norm = _GroupNorm(groups, input_dim, device=device)

    def init_extra_(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, temperature: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        ze = self.group_norm(self.proj(x.transpose(1, 2)).transpose(1, 2).float())
        zeg = ze.reshape(B, T, G, self.var_dim)
        emb = self.embedding.float().expand(V, G, self.var_dim).permute(1, 0, 2)  # [G, V, D]
        d = torch.linalg.vector_norm(zeg[:, :, :, None, :] - emb[None, None], dim=-1)
        idx = d.argmin(dim=-1)  # [B, T, G]
        zq = emb[torch.arange(G, device=x.device)[None, None, :], idx]  # [B, T, G, D]
        latent = (zq - zeg.detach()).square().mean()
        commitment = (zeg - zq.detach()).square().mean()
        st = zq.detach() + (zeg - zeg.detach())
        hard = F.one_hot(idx.reshape(-1, G), V).float()
        code_ppl = _perplexity(hard.mean(dim=0))
        return {"x": st.reshape(B, T, self.vq_dim), "prob_perplexity": code_ppl,
                "code_perplexity": code_ppl, "num_vars": V * G,
                "kmeans_loss": latent + self.gamma * commitment}


@dataclass(frozen=True)
class W2V2PretrainConfig:
    """The JAX ``W2V2PretrainConfig`` (``wav2vec2_pretraining.py:254-277``),
    its defaults included (``encoder_heads`` 8: fairseq's base has 12,
    ROADMAP C)."""

    encoder_embed_dim: int = 768
    encoder_ffn_dim: int = 3072
    encoder_layers: int = 12
    encoder_heads: int = 8
    conv_spec: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_SPEC
    extractor_mode: str = "default"
    final_dim: int = 256
    latent_vars: int = 320
    latent_groups: int = 2
    logit_temp: float = 0.1
    num_negatives: int = 100
    mask_prob: float = 0.65
    mask_length: int = 10
    quantizer_type: str = "gumbel"
    kmeans_gamma: float = 0.25
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dropout: float = 0.1
    features_pen_weight: float = 10.0


class Wav2Vec2PretrainModel(nn.Module):
    def __init__(self, cfg: W2V2PretrainConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        # the JAX trunk's attention and activation dropout defaults (0.1, 0.0)
        self.wav2vec_model = Wav2Vec2Encoder(
            c.encoder_embed_dim, c.encoder_ffn_dim, c.encoder_layers, c.encoder_heads,
            c.conv_spec, conv_pos=c.conv_pos, conv_pos_groups=c.conv_pos_groups,
            dropout=c.dropout, attention_dropout=0.1, activation_dropout=0.0,
            extractor_mode=c.extractor_mode, device=device)
        feat_dim = c.conv_spec[-1][0]
        self.mask_emb = nn.Parameter(torch.zeros(c.encoder_embed_dim, device=device))
        if c.quantizer_type == "kmeans":
            self.quantizer = KmeansVectorQuantizer(feat_dim, c.latent_vars, c.latent_groups,
                                                   feat_dim, gamma=c.kmeans_gamma, device=device)
            q_dim = feat_dim
        else:
            self.quantizer = GumbelVectorQuantizer(feat_dim, c.latent_vars, c.latent_groups,
                                                   c.final_dim, device=device)
            q_dim = c.final_dim
        self.project_q = linear(q_dim, c.final_dim, device=device)
        self.final_proj = linear(c.encoder_embed_dim, c.final_dim, device=device)

    def init_extra_(self, generator: torch.Generator) -> None:
        self.mask_emb.uniform_(0.0, 1.0, generator=generator)

    def aligned_features(self, source, padding_mask=None,
                         generator: Optional[torch.Generator] = None):
        """The unmasked context features [B, T', C] and their padding mask:
        what ``aligning_loss_bimodal`` compares."""
        return self.wav2vec_model(source, padding_mask, generator)

    def _contrastive_logits(self, preds, targets, neg_idx):
        """preds / targets [B, T, D], neg_idx [B, T, N] -> logits [B, T, 1+N]."""
        B = targets.shape[0]
        negs = targets[torch.arange(B, device=targets.device)[:, None, None], neg_idx.long()]
        cands = torch.cat([targets[:, :, None, :], negs], dim=2)  # [B, T, 1+N, D]
        p, cand = preds.float(), cands.float()
        p = p / torch.linalg.vector_norm(p, dim=-1, keepdim=True).clamp(min=1e-8)
        cand = cand / torch.linalg.vector_norm(cand, dim=-1, keepdim=True).clamp(min=1e-8)
        logits = torch.einsum("btd,btnd->btn", p, cand) / self.cfg.logit_temp
        same = torch.isclose(cands[:, :, 1:], cands[:, :, :1]).all(dim=-1)
        neg_logits = logits[:, :, 1:].masked_fill(same, float("-inf"))
        return torch.cat([logits[:, :, :1], neg_logits], dim=2)

    def _pretrain_streams(self, source, padding_mask, mask_indices, gumbel_temp, generator):
        """One modality's (preds, targets, quantizer outputs, feature
        penalty, valid frames)."""
        tr = self.wav2vec_model
        features = tr.feature_extractor(source)
        features_pen = features.float().square().mean()
        features = tr.layer_norm(features)
        if padding_mask is not None:
            padding_mask = downsample_padding_mask(padding_mask, features.shape[1])
        unmasked = features
        x = tr.post_extract_proj(features) if tr.post_extract_proj is not None else features
        x = torch.where(mask_indices[:, :, None], self.mask_emb.to(x.dtype), x)
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[:, :, None], 0.0)
        x = x + tr.encoder.pos_conv[0](x)
        if not tr.layer_norm_first:
            x = tr.encoder.layer_norm(x)
        for layer in tr.encoder.layers:
            x = layer(x, padding_mask, generator)
        q = self.quantizer(unmasked, gumbel_temp, generator)
        targets = self.project_q(q["x"])
        preds = self.final_proj(x)
        valid = mask_indices if padding_mask is None else mask_indices & ~padding_mask
        return preds, targets, q, features_pen, valid

    def _outputs(self, preds, targets, negative_indices, q, features_pen, valid):
        return {"logits": self._contrastive_logits(preds, targets, negative_indices),
                "mask": valid, "prob_perplexity": q["prob_perplexity"],
                "num_vars": q["num_vars"], "features_pen": features_pen,
                "kmeans_loss": q.get("kmeans_loss", torch.zeros((), device=preds.device))}

    def bimodal_forward(self, source, source2, padding_mask, padding_mask2, mask_indices,
                        negative_indices, gumbel_temp: float = 2.0,
                        generator: Optional[torch.Generator] = None):
        """Cross-modal pre-training (JAX ``:425-451``): each modality's
        masked-context predictions against the other's quantized targets
        over the shared mask -> (outputs 1->2, outputs 2->1)."""
        p1, t1, q1, pen1, v1 = self._pretrain_streams(source, padding_mask, mask_indices,
                                                      gumbel_temp, generator)
        p2, t2, q2, pen2, v2 = self._pretrain_streams(source2, padding_mask2, mask_indices,
                                                      gumbel_temp, generator)
        valid = v1 & v2
        return (self._outputs(p1, t2, negative_indices, q2, pen1, valid),
                self._outputs(p2, t1, negative_indices, q1, pen2, valid))

    def forward(self, source, padding_mask, mask_indices, negative_indices,
                gumbel_temp: float = 2.0, generator: Optional[torch.Generator] = None):
        preds, targets, q, pen, valid = self._pretrain_streams(
            source, padding_mask, mask_indices, gumbel_temp, generator)
        return self._outputs(preds, targets, negative_indices, q, pen, valid)


def build_w2v2_pretrain(cfg_dict: Dict, device="cuda") -> Wav2Vec2PretrainModel:
    known = {f.name for f in dataclasses.fields(W2V2PretrainConfig)}
    kw = {k: v for k, v in cfg_dict.items() if k in known}
    if kw.get("conv_spec") is not None:
        kw["conv_spec"] = tuple(map(tuple, kw["conv_spec"]))
    return Wav2Vec2PretrainModel(W2V2PretrainConfig(**kw), device=device)


def wav2vec2_large(cfg: Dict) -> Dict:
    d = dict(cfg)
    d.setdefault("encoder_embed_dim", 1024)
    d.setdefault("encoder_ffn_dim", 4096)
    d.setdefault("encoder_layers", 24)
    d.setdefault("encoder_heads", 16)
    d.setdefault("final_dim", 768)
    d.setdefault("extractor_mode", "layer_norm")
    return d


MODEL_BUILDERS = {"wav2vec2": build_w2v2_pretrain, "wav2vec2_quasiwave": build_w2v2_pretrain}
ARCHITECTURES = {"wav2vec2": ("wav2vec2", dict),
                 "wav2vec2_large": ("wav2vec2", wav2vec2_large),
                 "wav2vec2_quasiwave": ("wav2vec2_quasiwave", dict),
                 "wav2vec2_quasiwave_base": ("wav2vec2_quasiwave", dict)}
