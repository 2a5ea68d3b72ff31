"""wav2vec v1 (counterpart of chimera_st_tpu/models/wav2vec_v1.py; fairseq
``wav2vec.py``): a strided conv feature encoder z = f(x) (GroupNorm of one
group, ReLU), a causal conv aggregator c = g(z) with residuals where the
shapes agree, one bias-free linear predictor per step ahead, and the binary
cross entropy of ``wav2vec_v1`` over (1 positive, N negatives) per (step,
position). The negatives are host-sampled time indices; no kernel runs on
this path. Module names follow the JAX tree (``feat_conv_{i}`` ->
``feature_convs.{i}``, ``feat_norm_{i}`` -> ``feature_norms.{i}``,
``agg_conv_{i}`` -> ``agg_convs.{i}``, ``pred_{k}`` ->
``step_predictors.{k}``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv1d, linear
from .wav2vec2_pretraining import _GroupNorm


@dataclass(frozen=True)
class Wav2VecV1Config:
    conv_feature_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2),
    )
    conv_aggregator_layers: Tuple[Tuple[int, int, int], ...] = ((512, 3, 1),) * 9
    prediction_steps: int = 12
    num_negatives: int = 10
    dropout: float = 0.0


def feature_length(n_samples: int, cfg: Wav2VecV1Config) -> int:
    """Frames of the feature encoder for ``n_samples`` raw samples."""
    for _, k, s in cfg.conv_feature_layers:
        n_samples = (n_samples - k) // s + 1
    return n_samples


class Wav2VecV1Model(nn.Module):
    def __init__(self, cfg: Wav2VecV1Config, device="cuda"):
        super().__init__()
        self.cfg = c = cfg
        convs, norms, in_ch = [], [], 1
        for dim, k, s in c.conv_feature_layers:
            convs.append(conv1d(in_ch, dim, k, stride=s, device=device))
            norms.append(_GroupNorm(1, dim, device=device))
            in_ch = dim
        self.feature_convs, self.feature_norms = nn.ModuleList(convs), nn.ModuleList(norms)
        aggs = []
        for dim, k, s in c.conv_aggregator_layers:
            aggs.append(conv1d(in_ch, dim, k, stride=s, device=device))
            in_ch = dim
        self.agg_convs = nn.ModuleList(aggs)
        z_dim = c.conv_feature_layers[-1][0]
        self.step_predictors = nn.ModuleList(
            [linear(in_ch, z_dim, bias=False, device=device) for _ in range(c.prediction_steps)])

    def featurize(self, source: torch.Tensor) -> torch.Tensor:
        """raw wave [B, T] -> z [B, T', D]."""
        x = source[:, None, :].to(self.feature_convs[0].weight.dtype)
        for conv, norm in zip(self.feature_convs, self.feature_norms):
            y = conv(x).transpose(1, 2)
            x = F.relu(norm(y).to(y.dtype)).transpose(1, 2)
        return x.transpose(1, 2)

    def aggregate(self, z: torch.Tensor) -> torch.Tensor:
        """Causal convs (flax ``padding="CAUSAL"``: k - 1 frames on the left)."""
        x = z.transpose(1, 2)
        for conv in self.agg_convs:
            residual = x
            x = F.relu(conv(F.pad(x, (conv.kernel_size[0] - 1, 0))))
            if x.shape == residual.shape:
                x = x + residual
        return x.transpose(1, 2)

    def forward(self, source: torch.Tensor, negative_indices: torch.Tensor):
        """-> (pos_logits [B, K, T'], neg_logits [B, K, T', N]); negative
        time indices [B, T', N] are clipped to the utterance."""
        z = self.featurize(source)
        ca = self.aggregate(z)
        B, T, _ = z.shape
        idx = negative_indices.long().clamp(0, T - 1)
        negs = z[torch.arange(B, device=z.device)[:, None, None], idx]  # [B, T, N, D]
        pos_list, neg_list = [], []
        for k, pred in enumerate(self.step_predictors, start=1):
            p = pred(ca)
            valid = torch.arange(T, device=z.device) < (T - k)
            pos = (p * torch.roll(z, -k, dims=1)).sum(dim=-1)
            pos_list.append(torch.where(valid[None, :], pos, 0.0))
            neg = torch.einsum("btd,btnd->btn", p, negs)
            neg_list.append(torch.where(valid[None, :, None], neg, 0.0))
        return torch.stack(pos_list, 1), torch.stack(neg_list, 1)


def build_wav2vec_v1(cfg_dict: Dict, device="cuda") -> Wav2VecV1Model:
    known = {f.name for f in dataclasses.fields(Wav2VecV1Config)}
    kw = {k: v for k, v in cfg_dict.items() if k in known}
    for key in ("conv_feature_layers", "conv_aggregator_layers"):
        if kw.get(key):
            kw[key] = tuple(tuple(x) for x in kw[key])
    return Wav2VecV1Model(Wav2VecV1Config(**kw), device=device)


MODEL_BUILDERS = {"wav2vec": build_wav2vec_v1}
ARCHITECTURES = {"wav2vec": ("wav2vec", dict)}
