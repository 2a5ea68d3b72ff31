"""Optimizers (counterpart of chimera_st_tpu/optim/optimizers.py, the Adam
the recipes use). bf16 compute over fp32 parameters needs no loss scaler.

``adam``: ``torch.optim.Adam`` (the update of ``optax.adam``); with
``weight_decay`` > 0 ``torch.optim.AdamW``, a decoupled decay as
``optax.adamw`` (not Adam's L2 on the gradient). Both run fused, whose
``found_inf`` skips an update on the device: parameters, moments and
steps stay as they were, as the JAX step's non-finite skip leaves them.
The learning rate of each update is set by the caller from the schedule.
``clip_norm`` > 0 clips as ``optax.clip_by_global_norm``. Parameters
frozen by a ``--fix-*`` flag (``optim/freeze.py``) stay out of the torch
optimizer; the clip then takes the norm of the trained gradients alone, as
the clip inside optax's ``multi_transform`` does. ``state_to_optax`` / ``load_optax`` carry the
state to and from the JAX checkpoint's optax tree (``convert``).
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

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
        return torch.optim.AdamW(params, lr=0.0, betas=betas, eps=eps, weight_decay=wd,
                                 fused=True)
    return torch.optim.Adam(params, lr=0.0, betas=betas, eps=eps, fused=True)


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
    clip of the JAX chain (clip, then the optimizer). ``frozen``: parameters
    that keep their gradient and are never stepped."""

    def __init__(self, optimizer: torch.optim.Optimizer, clip_norm: float = 0.0,
                 frozen: Sequence[torch.nn.Parameter] = ()):
        self.optimizer, self.clip_norm = optimizer, clip_norm
        self.frozen = list(frozen)

    def _trained(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def step(self, lr, g_norm: torch.Tensor, skip: Optional[torch.Tensor] = None) -> None:
        """One update of the parameters whose ``.grad`` is set, at ``lr`` (a
        float, or an fp32 scalar tensor on the parameters' device);
        ``g_norm`` is the global norm of every gradient, frozen ones too.
        Where the device scalar ``skip`` is true the update leaves every
        parameter and every state as it was."""
        if self.clip_norm > 0:
            grads = [p.grad for p in self._trained() if p.grad is not None]
            if self.frozen:
                from ..train.train_step import global_norm

                g_norm = global_norm(grads)
            clip_by_global_norm_(grads, self.clip_norm, g_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.found_inf = None if skip is None else skip.float()
        try:
            self.optimizer.step()
        finally:
            self.optimizer.found_inf = None

    @property
    def decoupled(self) -> bool:
        return isinstance(self.optimizer, torch.optim.AdamW)

    def state_to_optax(self, model: torch.nn.Module, schedule_count: int) -> Dict[str, Any]:
        """The optax tree a JAX checkpoint of this optimizer holds, numpy
        leaves copied to the host once."""
        from ..convert import model_kind, opt_state_to_optax

        trained = {id(p) for p in self._trained()}
        state = {}
        for name, p in model.named_parameters():
            s = self.optimizer.state.get(p, {}) if id(p) in trained else None
            state[name] = None if s is None else {
                k: (v.detach().cpu().numpy() if k != "step" else int(v)) for k, v in s.items()}
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        return opt_state_to_optax(state, shapes, schedule_count, model=model_kind(model),
                                  clip=self.clip_norm > 0, decoupled=self.decoupled)

    def load_optax(self, tree: Any, model: torch.nn.Module) -> int:
        """Restores the state from an optax tree of this optimizer's layout
        (ValueError otherwise, leaving the state as it was); returns the
        schedule's count."""
        from ..convert import model_kind, opt_state_from_optax

        trained = {id(p) for p in self._trained()}
        named = dict(model.named_parameters())
        frozen = {n for n, p in named.items() if id(p) not in trained}
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        state, schedule_count = opt_state_from_optax(
            tree, frozen, shapes, model=model_kind(model), clip=self.clip_norm > 0,
            decoupled=self.decoupled)
        self.optimizer.state.clear()
        for name, s in state.items():
            if s:
                p = named[name]
                self.optimizer.state[p] = {
                    "step": s["step"].to(p.device), "exp_avg": s["exp_avg"].to(p.device),
                    "exp_avg_sq": s["exp_avg_sq"].to(p.device)}
        return schedule_count


def build_optimizer(cfg: Dict, params: Iterable[torch.nn.Parameter],
                    clip_norm: float = 0.0,
                    frozen: Sequence[torch.nn.Parameter] = ()) -> Optimizer:
    make: Callable = OPTIMIZERS.get(cfg.get("_name", "adam"))
    return Optimizer(make(cfg, params), clip_norm, frozen)
