"""Audio feature transforms of the fbank path (own copy of
chimera_st_tpu/data/feature_transforms.py): the registry and composite,
SpecAugment (frequency and time masking, optional time warp) and global and
utterance CMVN. They run on the host in numpy on [T, F] features, drawing
from ``np.random`` in the JAX package's order."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

FEATURE_TRANSFORMS: Dict[str, type] = {}


def register_feature_transform(name: str) -> Callable[[type], type]:
    def register(cls: type) -> type:
        if name in FEATURE_TRANSFORMS:
            raise ValueError(f"feature transform {name!r} is registered twice")
        FEATURE_TRANSFORMS[name] = cls
        return cls

    return register


class CompositeAudioFeatureTransform:
    """The transforms named by ``config["transforms"]``, in order, each built
    from ``config[name]`` (its parameters; none: the defaults)."""

    @classmethod
    def from_config_dict(cls, config: Optional[Dict]):
        if config is None or "transforms" not in config:
            return None
        transforms = []
        for name in config["transforms"]:
            if name not in FEATURE_TRANSFORMS:
                raise KeyError(f"unknown feature transform {name!r} "
                               f"(known: {sorted(FEATURE_TRANSFORMS)})")
            transforms.append(FEATURE_TRANSFORMS[name].from_config_dict(config.get(name, {})))
        return cls(transforms)

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            x = t(x)
        return x


@register_feature_transform("specaugment")
class SpecAugmentTransform:
    """Frequency and time masks (filled with the spectrogram's mean) and an
    optional piecewise-linear time warp around one random control point
    (``time_warp_W`` 0, the default, is off)."""

    @classmethod
    def from_config_dict(cls, config: Optional[Dict] = None):
        c = config or {}
        return cls(freq_mask_n=c.get("freq_mask_N", 1), freq_mask_f=c.get("freq_mask_F", 27),
                   time_mask_n=c.get("time_mask_N", 1), time_mask_t=c.get("time_mask_T", 100),
                   time_mask_p=c.get("time_mask_p", 1.0), time_warp_w=c.get("time_warp_W", 0))

    def __init__(self, freq_mask_n=1, freq_mask_f=27, time_mask_n=1, time_mask_t=100,
                 time_mask_p=1.0, time_warp_w=0):
        self.freq_mask_n, self.freq_mask_f = freq_mask_n, freq_mask_f
        self.time_mask_n, self.time_mask_t, self.time_mask_p = time_mask_n, time_mask_t, time_mask_p
        self.time_warp_w = time_warp_w

    def _time_warp(self, spec: np.ndarray) -> np.ndarray:
        T = spec.shape[0]
        W = self.time_warp_w
        if W <= 0 or T <= 2 * W + 1:
            return spec
        center = np.random.randint(W, T - W)
        w = np.random.randint(-W, W + 1)
        if w == 0:
            return spec
        # output frame positions sampled from the original: 0 -> 0,
        # center + w -> center, T - 1 -> T - 1
        src_pts = np.array([0.0, center + w, T - 1.0])
        dst_pts = np.array([0.0, float(center), T - 1.0])
        sample_at = np.interp(np.arange(T, dtype=np.float64), src_pts, dst_pts)
        lo = np.floor(sample_at).astype(np.int64)
        hi = np.minimum(lo + 1, T - 1)
        frac = (sample_at - lo)[:, None]
        return (1.0 - frac) * spec[lo] + frac * spec[hi]

    def __call__(self, spec: np.ndarray) -> np.ndarray:
        spec = spec.copy()
        T, F = spec.shape
        spec = self._time_warp(spec).astype(spec.dtype)
        mean = spec.mean()
        for _ in range(self.freq_mask_n):
            f = np.random.randint(0, self.freq_mask_f + 1)
            if 0 < f < F:
                f0 = np.random.randint(0, F - f)
                spec[:, f0:f0 + f] = mean
        max_t = min(self.time_mask_t, int(self.time_mask_p * T))
        for _ in range(self.time_mask_n):
            t = np.random.randint(0, max_t + 1) if max_t > 0 else 0
            if 0 < t < T:
                t0 = np.random.randint(0, T - t)
                spec[t0:t0 + t, :] = mean
        return spec


@register_feature_transform("global_cmvn")
class GlobalCMVN:
    """(x - mean) / std with the statistics of ``stats_npz_path``."""

    @classmethod
    def from_config_dict(cls, config: Optional[Dict] = None):
        stats = np.load((config or {})["stats_npz_path"])
        return cls(stats["mean"], stats["std"])

    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = mean
        self.std = np.maximum(std, 1e-8)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std


@register_feature_transform("utterance_cmvn")
class UtteranceCMVN:
    """Each utterance normalised by its own per-channel mean and std."""

    @classmethod
    def from_config_dict(cls, config: Optional[Dict] = None):
        c = config or {}
        return cls(c.get("norm_means", True), c.get("norm_vars", True))

    def __init__(self, norm_means=True, norm_vars=True):
        self.norm_means, self.norm_vars = norm_means, norm_vars

    def __call__(self, x: np.ndarray) -> np.ndarray:
        mean = x.mean(axis=0) if self.norm_means else 0.0
        std = x.std(axis=0) if self.norm_vars else 1.0
        return (x - mean) / np.maximum(std, 1e-8)
