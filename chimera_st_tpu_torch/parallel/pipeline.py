"""Pipeline parallelism over the ``pipe`` ranks of a mesh: the GPipe
schedule (counterpart of chimera_st_tpu/parallel/pipeline.py).

The JAX package runs the schedule as one SPMD program (``shard_map`` with a
``lax.scan`` over ticks and ``ppermute`` between stages). Here each pipe
rank is a process and the schedule is explicit:

- forward: at tick ``t`` stage ``s`` works on micro-batch ``t - s``; it
  receives that micro-batch's activation from stage ``s - 1`` (stage 0 takes
  it from the input), runs its layers and sends the result to ``s + 1``.
  The last stage's outputs are then broadcast over the pipe ranks (the JAX
  masked ``psum``), so every rank continues with the whole output;
- backward (``_GPipe``, an autograd Function, since autograd does not pass
  through ``send`` / ``recv``): the last stage starts from the output's
  gradient, each stage back-propagates its micro-batches through its own
  layers and sends the input's gradient to ``s - 1``. The stacked layer
  parameters' gradients (each nonzero only on its stage) and those of the
  side inputs are summed over the pipe ranks, and stage 0's input gradient
  is broadcast, so that every pipe rank holds the one-process gradient.

Every rank keeps all layers' parameters (as the JAX package's per-layer
path keeps them replicated); a stage reads only its own slice.
``remat`` runs each stage under ``torch.utils.checkpoint`` (the reference's
``--pipeline-checkpoint``). The bubble is ``(stages - 1) / (chunks + stages
- 1)``. Layers inside the schedule run without dropout, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.utils.checkpoint

Params = Dict[str, torch.Tensor]


def stack_stage_params(per_layer_params: Sequence[Params], n_stages: int) -> Params:
    """[L layer dicts] -> one dict with leading [n_stages, L / n_stages];
    stage s owns layers ``s * L / n .. (s + 1) * L / n - 1``."""
    n_layers = len(per_layer_params)
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers do not divide into {n_stages} equal stages "
                         "(only uniform --pipeline-balance is supported)")
    per = n_layers // n_stages
    return {k: torch.stack([p[k] for p in per_layer_params]).reshape(
        (n_stages, per) + tuple(per_layer_params[0][k].shape)) for k in per_layer_params[0]}


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [num_microbatches, B / num_microbatches, ...]."""
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(f"batch {b} does not divide into {num_microbatches}")
    return x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))


def make_layer_stage_fn(layer_apply: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
    """``layer_apply(layer_params, x, *extras) -> x`` ->
    ``stage_fn(stage_params, x, *extras) -> x`` over the stage's layers
    (its params with a leading [layers_per_stage] axis)."""

    def stage_fn(stage_params: Params, x, *extras):
        n = next(iter(stage_params.values())).shape[0]
        for i in range(n):
            x = layer_apply({k: v[i] for k, v in stage_params.items()}, x, *extras)
        return x

    return stage_fn


def pipeline_bubble_fraction(n_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule."""
    return (n_stages - 1) / (num_microbatches + n_stages - 1)


def _pipe_ranks(mesh, axis):
    return mesh.ranks(axis), mesh.group(axis), mesh.index(axis)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, meta, mb, *flat):
        stage_fn, mesh, axis, remat, names, n_extras, train = meta
        extras, stacked = flat[:n_extras], flat[n_extras:]
        ranks, group, s = _pipe_ranks(mesh, axis)
        S, M = len(ranks), mb.shape[0]
        local = {n: t[s].detach().requires_grad_(train and t.requires_grad)
                 for n, t in zip(names, stacked)}
        ex = [e.detach().requires_grad_(train and e.requires_grad)
              if e.is_floating_point() else e for e in extras]
        fn = stage_fn
        if remat and train:
            def fn(p, x, *e):
                return torch.utils.checkpoint.checkpoint(stage_fn, p, x, *e,
                                                         use_reentrant=False)
        inputs, outputs, sends = {}, {}, []
        outs = torch.zeros_like(mb)
        with torch.set_grad_enabled(train):
            for t in range(M + S - 1):
                m = t - s
                if not 0 <= m < M:
                    continue
                if s == 0:
                    x = mb[m].detach()
                else:
                    x = torch.empty_like(mb[m])
                    dist.recv(x, ranks[s - 1], group=group)
                x.requires_grad_(train)
                y = fn(local, x, *[e[m] for e in ex])
                inputs[m], outputs[m] = x, y
                if s < S - 1:
                    sends.append(dist.isend(y.detach().to(mb.dtype).contiguous(),
                                            ranks[s + 1], group=group))
                else:
                    outs[m] = y.detach()
        for req in sends:
            req.wait()
        dist.broadcast(outs, ranks[S - 1], group=group)
        ctx.meta, ctx.state = meta, (local, ex, inputs, outputs)
        ctx.shapes = (mb.shape, [t.shape for t in stacked])
        return outs

    @staticmethod
    def backward(ctx, grad_outs):
        names = ctx.meta[4]
        local, ex, inputs, outputs = ctx.state
        ranks, group, s = _pipe_ranks(ctx.meta[1], ctx.meta[2])
        S = len(ranks)
        mb_shape, stacked_shapes = ctx.shapes
        M = mb_shape[0]
        grad_mb = torch.zeros(mb_shape, dtype=grad_outs.dtype, device=grad_outs.device)
        sends = []
        for m in reversed(range(M)):
            if s == S - 1:
                g = grad_outs[m]
            else:
                g = torch.empty_like(grad_outs[m])
                dist.recv(g, ranks[s + 1], group=group)
            torch.autograd.backward(outputs[m], g.to(outputs[m].dtype))
            gx = inputs[m].grad
            if s > 0:
                sends.append(dist.isend(gx.to(grad_outs.dtype).contiguous(), ranks[s - 1],
                                        group=group))
            else:
                grad_mb[m] = gx
        for req in sends:
            req.wait()
        dist.broadcast(grad_mb, ranks[0], group=group)
        grads_stacked = []
        for n, shape in zip(names, stacked_shapes):
            g = torch.zeros(shape, dtype=local[n].dtype, device=local[n].device)
            if local[n].grad is not None:
                g[s] = local[n].grad
            dist.all_reduce(g, group=group)
            grads_stacked.append(g)
        grads_extras = []
        for e in ex:
            if e.is_floating_point() and e.requires_grad:
                g = e.grad if e.grad is not None else torch.zeros_like(e)
                dist.all_reduce(g, group=group)
                grads_extras.append(g)
            else:
                grads_extras.append(None)
        return (None, grad_mb, *grads_extras, *grads_stacked)


def pipeline_apply(stage_fn: Callable[..., torch.Tensor], stacked_params: Params,
                   microbatches: torch.Tensor, extras: Sequence[torch.Tensor] = (), *,
                   mesh, axis: str = "pipe", remat: bool = False) -> torch.Tensor:
    """The GPipe schedule of one layer stack over ``mesh``'s ``axis`` ranks.

    ``stage_fn(stage_params, x, *extras_m) -> x`` keeps x's shape;
    ``stacked_params`` has leading [n_stages, layers_per_stage]; the
    micro-batches [num_micro, mb, ...] enter stage 0; each extra is
    [num_micro, mb, ...] and reaches every stage with its micro-batch.
    Returns [num_micro, mb, ...] outputs on every pipe rank."""
    names = list(stacked_params)
    n_stages = mesh.shape[axis]
    for n in names:
        if stacked_params[n].shape[0] != n_stages:
            raise ValueError(f"{n}: {stacked_params[n].shape[0]} stages, the mesh has "
                             f"{n_stages}")
    meta = (stage_fn, mesh, axis, remat, names, len(extras), torch.is_grad_enabled())
    return _GPipe.apply(meta, microbatches, *extras, *[stacked_params[n] for n in names])


def pipelined_layer_stack(per_layer_params: Union[Sequence[Params], Params],
                          layer_apply: Callable[..., torch.Tensor], x: torch.Tensor,
                          extras: Sequence[torch.Tensor] = (), *, mesh, stages: int,
                          chunks: int = 0, remat: bool = False) -> Optional[torch.Tensor]:
    """The models' one call: stack the layers' parameters (a list of
    per-layer dicts, or a dict already stacked on a leading [L] axis),
    micro-batch x [B, ...] and its extras into ``chunks`` (default: the
    stage count), run the schedule, restore the shape. None where B does
    not divide into ``chunks`` (the caller runs its layers in sequence)."""
    chunks = chunks or stages
    b = x.shape[0]
    if b % chunks != 0:
        return None
    if isinstance(per_layer_params, (list, tuple)):
        stacked = stack_stage_params(per_layer_params, stages)
    else:
        n_layers = next(iter(per_layer_params.values())).shape[0]
        if n_layers % stages != 0:
            raise ValueError(f"{n_layers} layers / {stages} stages uneven")
        stacked = {k: v.reshape((stages, n_layers // stages) + tuple(v.shape[1:]))
                   for k, v in per_layer_params.items()}
    out = pipeline_apply(make_layer_stage_fn(layer_apply), stacked, microbatch(x, chunks),
                         [microbatch(e, chunks) for e in extras], mesh=mesh, remat=remat)
    return out.reshape(x.shape)


def pipelined_modules(layers: Sequence[torch.nn.Module], call: Callable[..., torch.Tensor],
                      x: torch.Tensor, extras: Sequence[torch.Tensor], pipeline: Dict[str, Any]
                      ) -> Optional[torch.Tensor]:
    """A stack of identical layers through the schedule: their parameters
    stacked at the call (the gradients flow back to each layer's own), each
    layer applied as ``call(layers[0] with its parameters, h, *extras)``.
    ``pipeline``: ``mesh``, ``stages``, ``chunks``, ``remat``. None for a
    batch that does not divide into the chunks."""
    from torch.func import functional_call

    template = layers[0]

    def layer_apply(params, h, *e):
        return functional_call(template, params, (h, *e), strict=True)

    def apply(params, h, *e):
        return call(lambda *args: layer_apply(params, *args), h, *e)

    return pipelined_layer_stack([dict(l.named_parameters()) for l in layers], apply, x,
                                 extras, mesh=pipeline["mesh"], stages=pipeline["stages"],
                                 chunks=pipeline["chunks"], remat=pipeline["remat"])


def pipeline_config(cfg, mesh, check_dropout: bool = True) -> Optional[Dict[str, Any]]:
    """A model config's pipeline (``pipeline_stages`` above 1) over ``mesh``,
    with the JAX builders' checks: a mesh whose ``pipe`` axis is the stage
    count, and no dropout (the schedule runs its layers without; the
    stacked LM's layers have none whatever its config says)."""
    if cfg.pipeline_stages <= 1:
        return None
    if mesh is None or mesh.shape.get("pipe", 1) != cfg.pipeline_stages:
        raise ValueError("pipeline_stages > 1 needs a mesh whose `pipe` axis equals the stage "
                         "count (train CLI: --pipeline-stages builds it)")
    if check_dropout and (cfg.dropout or cfg.attention_dropout or cfg.activation_dropout):
        raise ValueError("the pipeline path runs layers without dropout; set --dropout 0 "
                         "--attention-dropout 0 --activation-dropout 0")
    return {"mesh": mesh, "stages": cfg.pipeline_stages, "chunks": cfg.pipeline_chunks,
            "remat": cfg.pipeline_remat}
