"""Optimizers (counterpart of chimera_st_tpu/optim/optimizers.py, the Adam
the recipes use). bf16 compute over fp32 parameters needs no loss scaler.

``adam``: ``torch.optim.Adam`` (the update of ``optax.adam``); with
``weight_decay`` > 0 ``torch.optim.AdamW``, a decoupled decay as
``optax.adamw`` (not Adam's L2 on the gradient). The learning rate of each
update is set by the caller from the schedule. ``clip_norm`` > 0 clips as
``optax.clip_by_global_norm``.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

from ..config.registry import OPTIMIZERS, register_optimizer


def _parse_betas(v, default=(0.9, 0.999)) -> Tuple[float, float]:
    if v is None:
        return default
    if isinstance(v, str):
        return tuple(ast.literal_eval(v))
    return tuple(v)


@register_optimizer("adam")
def adam(cfg: Dict, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    betas = _parse_betas(cfg.get("adam_betas"), (0.9, 0.999))
    eps = float(cfg.get("adam_eps", 1e-8))
    wd = float(cfg.get("weight_decay", 0.0))
    if wd > 0:
        return torch.optim.AdamW(params, lr=0.0, betas=betas, eps=eps, weight_decay=wd)
    return torch.optim.Adam(params, lr=0.0, betas=betas, eps=eps)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         g_norm: torch.Tensor) -> None:
    """``optax.clip_by_global_norm`` in place: where ``g_norm >= max_norm``
    each gradient becomes ``(g / g_norm) * max_norm``, otherwise it stays as
    it is (no epsilon, unlike ``clip_grad_norm_``)."""
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


class Optimizer:
    """A torch optimizer with the update's learning rate and the global-norm
    clip of the JAX chain (clip, then the optimizer)."""

    def __init__(self, optimizer: torch.optim.Optimizer, clip_norm: float = 0.0):
        self.optimizer, self.clip_norm = optimizer, clip_norm

    def step(self, lr: float, g_norm: torch.Tensor) -> None:
        """One update of the parameters whose ``.grad`` is set, at ``lr``;
        ``g_norm`` is the gradients' global norm."""
        if self.clip_norm > 0:
            clip_by_global_norm_([p.grad for g in self.optimizer.param_groups
                                  for p in g["params"] if p.grad is not None],
                                 self.clip_norm, g_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()


def build_optimizer(cfg: Dict, params: Iterable[torch.nn.Parameter],
                    clip_norm: float = 0.0) -> Optimizer:
    make: Callable = OPTIMIZERS.get(cfg.get("_name", "adam"))
    return Optimizer(make(cfg, params), clip_norm)
