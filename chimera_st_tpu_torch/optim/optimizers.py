"""Optimizers (counterpart of chimera_st_tpu/optim/optimizers.py): the JAX
package's eight, with optax's update rules. bf16 compute over fp32
parameters needs no loss scaler.

``adam``: ``torch.optim.Adam`` (the update of ``optax.adam``); with
``weight_decay`` > 0 ``torch.optim.AdamW``, a decoupled decay as
``optax.adamw`` (not Adam's L2 on the gradient). Both run fused, whose
``found_inf`` skips an update on the device.

The other seven are ``OptaxRule`` subclasses, one update rule each,
written after optax 0.2.6 (``torch.optim``'s classes differ from it):

- ``adafactor``: ``optax.adafactor`` at its defaults (decay rate 0.8,
  second moments factored over the two largest axes where both are at least
  128, update clipped to block RMS 1, scaled by the parameter's RMS (at
  least 1e-3), eps 1e-30); ``weight_decay`` is its ``weight_decay_rate``,
  added after the learning rate. Its state is kept in each parameter's flax
  layout (``convert.checkpoint_axes``), where optax factors it.
- ``adagrad``: the sum of squares starts at 0.1, the update is ``g *
  rsqrt(sum + eps)`` (``adagrad_eps``).
- ``adadelta``: ``rho`` / ``eps`` of ``adadelta_rho`` / ``adadelta_eps``.
- ``sgd``: plain, or with ``momentum`` > 0 a trace ``t = g + momentum * t``.
- ``nag``: the Nesterov trace (``momentum``, default 0.99).
- ``adamax``: ``nu = max(|g| + eps, b2 * nu)``, update ``mu_hat / nu``.
- ``lamb``: ``scale_by_adam`` (``lamb_eps``), then the decoupled decay
  ``weight_decay``, then the trust ratio ``|p| / |u|`` (1 where either is
  0).

Adagrad, adadelta, sgd, nag and adamax take ``weight_decay`` as the JAX
package's ``_with_l2``: ``wd * param`` added to the gradient first.

Every optimizer honours the device scalar ``found_inf`` (set by
``Optimizer.step`` from its ``skip``): where it is true every parameter and
every state stays as it was, without a host read. The learning rate of
each update is set by the caller from the schedule. ``clip_norm`` > 0
clips as ``optax.clip_by_global_norm``. Parameters frozen by a ``--fix-*``
flag (``optim/freeze.py``) stay out of the torch optimizer and hold no
state; the clip then takes the norm of the trained gradients alone, as the
clip inside optax's ``multi_transform`` does. ``state_to_optax`` /
``load_optax`` carry the state to and from the JAX checkpoint's optax tree
(``convert``); ``read_optax`` reads such a tree without loading it.
"""

from __future__ import annotations

import ast
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.registry import OPTIMIZERS, register_optimizer


def _parse_betas(v, default=(0.9, 0.999)) -> Tuple[float, float]:
    if v is None:
        return default
    if isinstance(v, str):
        return tuple(ast.literal_eval(v))
    return tuple(v)


class OptaxRule(torch.optim.Optimizer):
    """One of optax's update rules over a torch parameter list. Subclasses
    set ``layout`` (the chain's entry in ``convert.OPTAX_CHAINS``),
    ``fields`` (the per-parameter state), ``counted`` (whether the state
    holds an update count) and write ``init`` and ``update``. The state is
    made at construction, as ``tx.init`` makes it. ``l2`` > 0 adds ``l2 *
    param`` to each gradient first."""

    layout = ""
    fields: Tuple[str, ...] = ()
    counted = False
    raw = False  # the state is kept in the flax layout

    def __init__(self, params, l2: float = 0.0, **defaults):
        super().__init__(params, dict(lr=0.0, **defaults))
        self.l2 = float(l2)
        self.found_inf: Optional[torch.Tensor] = None
        first = self.param_groups[0]["params"][0]
        self.count = torch.zeros((), dtype=torch.int32, device=first.device)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {k: v.detach() for k, v in self.init(p, group).items()}

    def init(self, p: torch.Tensor, group: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def update(self, p: torch.Tensor, g: torch.Tensor, state: Dict[str, torch.Tensor],
               group: Dict, t: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """-> (the parameter after the update, the new state); ``t`` is the
        count after this update (int32 on the device)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        keep = None if self.found_inf is None else self.found_inf.bool()

        def commit(dst: torch.Tensor, new: torch.Tensor) -> None:
            dst.copy_(new if keep is None else torch.where(keep, dst, new))

        t = self.count + 1
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not self.l2 else p.grad + self.l2 * p
                state = self.state[p]
                new_p, new_state = self.update(p, g, state, group, t)
                for k, v in new_state.items():
                    commit(state[k], v)
                commit(p, new_p)
        if self.counted:
            commit(self.count, t)


class Adafactor(OptaxRule):
    """``optax.adafactor`` at the JAX package's settings;
    ``MIN_DIM_SIZE_TO_FACTOR`` is optax's threshold for factoring."""

    layout = "adafactor"
    fields = ("v_row", "v_col", "v")
    counted = True
    raw = True
    DECAY_RATE, CLIPPING_THRESHOLD, EPS, MIN_SCALE = 0.8, 1.0, 1e-30, 1e-3
    MIN_DIM_SIZE_TO_FACTOR = 128

    def __init__(self, params, checkpoint_axes: Mapping[torch.nn.Parameter, Tuple[int, ...]],
                 weight_decay_rate: float = 0.0):
        self.axes = {p: tuple(checkpoint_axes.get(p, range(p.dim()))) for p in params}
        if weight_decay_rate:
            self.layout = "adafactor_decay"
        super().__init__(list(self.axes), weight_decay_rate=float(weight_decay_rate))

    def _factored(self, shape) -> Optional[Tuple[int, int]]:
        """optax's ``_factored_dims`` of a flax-layout shape."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.MIN_DIM_SIZE_TO_FACTOR:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, p, group):
        shape = tuple(p.permute(self.axes[p]).shape)
        dims = self._factored(shape)
        zeros = lambda s: torch.zeros(s, dtype=p.dtype, device=p.device)  # noqa: E731
        if dims is None:
            return {"v_row": zeros((1,)), "v_col": zeros((1,)), "v": zeros(shape)}
        d1, d0 = dims
        return {"v_row": zeros(np.delete(shape, d0).tolist()),
                "v_col": zeros(np.delete(shape, d1).tolist()), "v": zeros((1,))}

    def update(self, p, g, state, group, t):
        perm = self.axes[p]
        inverse = tuple(int(i) for i in np.argsort(perm))
        gf = g.permute(perm)
        decay = 1.0 - t.float() ** -self.DECAY_RATE
        sq = gf * gf + self.EPS
        dims = self._factored(tuple(gf.shape))
        new = {}
        if dims is not None:
            d1, d0 = dims
            v_row = decay * state["v_row"] + (1.0 - decay) * sq.mean(dim=d0)
            v_col = decay * state["v_col"] + (1.0 - decay) * sq.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = gf * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new.update(v_row=v_row, v_col=v_col)
        else:
            v = decay * state["v"] + (1.0 - decay) * sq
            u = gf * v ** -0.5
            new["v"] = v
        u = u.permute(inverse)
        # clip_by_block_rms, the learning rate, scale_by_param_block_rms
        u = u / torch.clamp(u.square().mean().sqrt() / self.CLIPPING_THRESHOLD, min=1.0)
        u = group["lr"] * u
        rms = p.square().mean().sqrt()
        u = u * torch.where(rms <= self.MIN_SCALE, self.MIN_SCALE, rms)
        if group["weight_decay_rate"]:
            u = u + group["weight_decay_rate"] * p
        return p - u, new


class Adagrad(OptaxRule):
    layout = "adagrad"
    fields = ("sum_of_squares",)

    def init(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def update(self, p, g, state, group, t):
        s = g * g + state["sum_of_squares"]
        u = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0) * g
        return p - group["lr"] * u, {"sum_of_squares": s}


class Adadelta(OptaxRule):
    layout = "adadelta"
    fields = ("e_g", "e_x")

    def init(self, p, group):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def update(self, p, g, state, group, t):
        rho, eps = group["rho"], group["eps"]
        e_g = (1 - rho) * g * g + rho * state["e_g"]
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * g
        e_x = (1 - rho) * u * u + rho * state["e_x"]
        return p - group["lr"] * u, {"e_g": e_g, "e_x": e_x}


class SGD(OptaxRule):
    """``optax.sgd``: without momentum no state; with it a trace, Nesterov
    or not."""

    def __init__(self, params, l2: float = 0.0, momentum: float = 0.0, nesterov: bool = False):
        self.layout = "momentum" if momentum > 0 else "sgd"
        self.fields = ("trace",) if momentum > 0 else ()
        super().__init__(params, l2=l2, momentum=float(momentum), nesterov=bool(nesterov))

    def init(self, p, group):
        return {"trace": torch.zeros_like(p)} if group["momentum"] > 0 else {}

    def update(self, p, g, state, group, t):
        m = group["momentum"]
        if m <= 0:
            return p - group["lr"] * g, {}
        trace = g + m * state["trace"]
        u = g + m * trace if group["nesterov"] else trace
        return p - group["lr"] * u, {"trace": trace}


class Adamax(OptaxRule):
    layout = "adamax"
    fields = ("mu", "nu")
    counted = True

    def init(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, p, g, state, group, t):
        b1, b2 = group["betas"]
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = torch.maximum(g.abs() + group["eps"], b2 * state["nu"])
        u = mu / (1 - b1 ** t.float()) / nu
        return p - group["lr"] * u, {"mu": mu, "nu": nu}


class Lamb(OptaxRule):
    layout = "lamb"
    fields = ("mu", "nu")
    counted = True

    def init(self, p, group):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, p, g, state, group, t):
        b1, b2 = group["betas"]
        mu = (1 - b1) * g + b1 * state["mu"]
        nu = (1 - b2) * g * g + b2 * state["nu"]
        tf = t.float()
        u = (mu / (1 - b1 ** tf)) / (torch.sqrt(nu / (1 - b2 ** tf)) + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        return p - group["lr"] * (u * ratio), {"mu": mu, "nu": nu}


def _l2(cfg: Dict) -> float:
    return float(cfg.get("weight_decay", 0.0))


@register_optimizer("adam")
def adam(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    betas = _parse_betas(cfg.get("adam_betas"), (0.9, 0.999))
    eps = float(cfg.get("adam_eps", 1e-8))
    wd = float(cfg.get("weight_decay", 0.0))
    if wd > 0:
        return torch.optim.AdamW(params, lr=0.0, betas=betas, eps=eps, weight_decay=wd,
                                 fused=True)
    return torch.optim.Adam(params, lr=0.0, betas=betas, eps=eps, fused=True)


@register_optimizer("adafactor")
def adafactor(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    if checkpoint_axes is None:
        raise ValueError("adafactor factors its moments over the parameters' flax layout: "
                         "pass checkpoint_axes (convert.checkpoint_axes(model))")
    return Adafactor(list(params), checkpoint_axes, weight_decay_rate=_l2(cfg))


@register_optimizer("adagrad")
def adagrad(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    return Adagrad(params, l2=_l2(cfg), eps=float(cfg.get("adagrad_eps", 1e-10)),
                   initial_accumulator_value=0.1)


@register_optimizer("adadelta")
def adadelta(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    return Adadelta(params, l2=_l2(cfg), rho=float(cfg.get("adadelta_rho", 0.9)),
                    eps=float(cfg.get("adadelta_eps", 1e-6)))


@register_optimizer("sgd")
def sgd(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    return SGD(params, l2=_l2(cfg), momentum=float(cfg.get("momentum", 0.0)))


@register_optimizer("nag")
def nag(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    return SGD(params, l2=_l2(cfg), momentum=float(cfg.get("momentum", 0.99)), nesterov=True)


@register_optimizer("adamax")
def adamax(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    return Adamax(params, l2=_l2(cfg), betas=_parse_betas(cfg.get("adamax_betas")),
                  eps=float(cfg.get("adamax_eps", 1e-8)))


@register_optimizer("lamb")
def lamb(cfg: Dict, params, checkpoint_axes=None) -> torch.optim.Optimizer:
    return Lamb(params, betas=_parse_betas(cfg.get("lamb_betas")),
                eps=float(cfg.get("lamb_eps", 1e-8)), weight_decay=_l2(cfg))


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

    @property
    def layout(self) -> str:
        """The chain's entry in ``convert.OPTAX_CHAINS``."""
        if isinstance(self.optimizer, torch.optim.Adam):  # AdamW too
            return "adamw" if self.decoupled else "adam"
        return self.optimizer.layout

    def _optax_options(self, model: torch.nn.Module) -> Dict[str, Any]:
        from ..convert import model_kind

        o = self.optimizer
        return dict(model=model_kind(model), clip=self.clip_norm > 0,
                    l2=bool(getattr(o, "l2", 0.0)), raw=bool(getattr(o, "raw", False)))

    def _fields(self, model: torch.nn.Module) -> Tuple[Dict[str, Any], int]:
        """The state by parameter name and field (None for a frozen
        parameter, host copies), and the optimizer's own count."""
        trained = {id(p) for p in self._trained()}
        if isinstance(self.optimizer, OptaxRule):
            fields = {name: {f: self.optimizer.state[p][f].detach().cpu().numpy()
                             for f in self.optimizer.fields} if id(p) in trained else None
                      for name, p in model.named_parameters()}
            return fields, int(self.optimizer.count)
        # torch Adam's exp_avg is optax's mu, exp_avg_sq its nu, the shared
        # step its count; no state yet (before the first update): zero moments
        fields, steps = {}, set()
        for name, p in model.named_parameters():
            s = self.optimizer.state.get(p, {}) if id(p) in trained else None
            if s is None:
                fields[name] = None
            elif not s:
                fields[name] = {f: np.zeros(tuple(p.shape), np.float32) for f in ("mu", "nu")}
            else:
                steps.add(int(s["step"]))
                fields[name] = {"mu": s["exp_avg"].detach().cpu().numpy(),
                                "nu": s["exp_avg_sq"].detach().cpu().numpy()}
        if len(steps) > 1:
            raise ValueError(f"parameters at different Adam steps {sorted(steps)}")
        return fields, (steps.pop() if steps else 0)

    def state_to_optax(self, model: torch.nn.Module, schedule_count: int) -> Dict[str, Any]:
        """The optax tree a JAX checkpoint of this optimizer holds, numpy
        leaves copied to the host once."""
        from ..convert import optimizer_state_to_optax

        fields, count = _gathered(model, *self._fields(model))
        return optimizer_state_to_optax(self.layout, fields, count, schedule_count,
                                        **self._optax_options(model))

    def read_optax(self, tree: Any, model: torch.nn.Module
                   ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], int, int]:
        """An optax tree of this optimizer's layout (ValueError otherwise)
        -> ({optax field: {trained parameter name: CPU tensor}}, the
        optimizer's count, the schedule's count); Adam's fields are ``mu`` /
        ``nu``. The state is not touched."""
        from ..convert import optimizer_state_from_optax, optimizer_state_to_optax

        options = self._optax_options(model)
        fields, _ = _gathered(model, *self._fields(model))
        template = optimizer_state_to_optax(self.layout, fields, 0, 0, **options)
        masked = any(f is None for f in fields.values())
        return optimizer_state_from_optax(tree, template, self.layout, masked=masked, **options)

    def load_optax(self, tree: Any, model: torch.nn.Module) -> int:
        """Restores the state from an optax tree of this optimizer's layout
        (ValueError otherwise, leaving the state as it was); returns the
        schedule's count."""
        from ..parallel.partition import shard_state_dict

        got, count, schedule_count = self.read_optax(tree, model)
        got = {f: shard_state_dict(model, by_name) for f, by_name in got.items()}
        named = dict(model.named_parameters())
        trained = {id(p) for p in self._trained()}
        o = self.optimizer
        if isinstance(o, OptaxRule):
            for name, p in named.items():
                if id(p) in trained:
                    for f in o.fields:
                        o.state[p][f].copy_(got[f][name])
            o.count.fill_(count)
            return schedule_count
        o.state.clear()
        if count:
            for name, p in named.items():
                if id(p) in trained:
                    o.state[p] = {"step": torch.tensor(float(count)).to(p.device),
                                  "exp_avg": got["mu"][name].to(p.device),
                                  "exp_avg_sq": got["nu"][name].to(p.device)}
        return schedule_count


def _gathered(model: torch.nn.Module, fields: Dict[str, Any], count: int):
    """The fields of a tensor-parallel model's shards gathered over its
    ``model`` ranks (collective), as the whole model's."""
    split = getattr(model, "tp_split", {})
    if not split:
        return fields, count
    from ..parallel.partition import gather_state_dict

    out = dict(fields)
    for name in split:
        if fields.get(name) is None:
            continue
        f = fields[name]
        out[name] = {k: gather_state_dict(model, {name: torch.from_numpy(v).to(
            next(model.parameters()).device)})[name].cpu().numpy() for k, v in f.items()}
    return out, count


def build_optimizer(cfg: Dict, params: Iterable[torch.nn.Parameter],
                    clip_norm: float = 0.0,
                    frozen: Sequence[torch.nn.Parameter] = (),
                    checkpoint_axes: Optional[Mapping[torch.nn.Parameter, Tuple[int, ...]]] = None
                    ) -> Optimizer:
    """The optimizer ``cfg["_name"]`` over ``params``; ``checkpoint_axes``
    (``convert.checkpoint_axes(model)``) gives adafactor each parameter's flax
    layout."""
    make: Callable = OPTIMIZERS.get(cfg.get("_name", "adam"))
    return Optimizer(make(cfg, list(params), checkpoint_axes), clip_norm, frozen)
