"""One rank of the gloo world that ``tests/test_torch_parallel.py`` starts.

It imports torch, numpy and the port only. ``run`` reads the scenarios'
inputs (``inputs.pkl``: weights as port state dicts, global batches,
attention blocks) from the test's directory, runs every scenario in turn on
this rank and, on rank 0, writes what each produced to ``results.pkl``. The
one-process runs of the same scenarios are ``train_updates`` /
``decode_batch`` with ``mesh=None``."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

LM = dict(vocab_size=40, embed_dim=32, ffn_dim=64, layers=4, heads=4, dropout=0.0,
          attention_dropout=0.0, activation_dropout=0.0)
OPT = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
SCHED = {"_name": "inverse_sqrt", "lr": 1e-3, "warmup_updates": 0}


def train_updates(arch: str, state_dict, batches, mesh=None, zero: bool = False,
                  pipeline: dict = None):
    """Adam updates of a tiny LM (``transformer_lm`` or the stacked
    ``transformer_lm_pipe``), one a global batch -> (per update: loss,
    gnorm, sample size), the first update's normalised gradients and the
    final parameters, whole (gathered over the model ranks)."""
    from chimera_st_tpu_torch.config.registry import CRITERIONS
    from chimera_st_tpu_torch.models.pipeline_lm import build_transformer_lm_pipe
    from chimera_st_tpu_torch.models.transformer_mt import build_transformer_lm
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.parallel.partition import (
        BATCH_PATHS, ZeroOptimizer, apply_tensor_parallel, gather_state_dict)
    from chimera_st_tpu_torch.tasks import language_modeling  # noqa: F401
    from chimera_st_tpu_torch.train import TrainStep

    cfg = dict(LM, **(pipeline or {}))
    build = build_transformer_lm_pipe if arch == "transformer_lm_pipe" else build_transformer_lm
    model = build(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    model.train()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        apply_tensor_parallel(model, mesh)
    params = list(model.parameters())
    opt = build_optimizer(OPT, params)
    if zero:
        opt = ZeroOptimizer(opt, params, mesh, lambda shards: build_optimizer(OPT, shards))
    step = TrainStep(model, CRITERIONS.get("lm_cross_entropy")({"padding_idx": 1}), opt,
                     build_lr_schedule(SCHED), compute_dtype=torch.float32, mesh=mesh, pad=1)
    metrics, grads = [], None
    before = dict(BATCH_PATHS)
    early = []
    for batch in batches:
        m = step([batch])
        metrics.append((m["loss"], m["gnorm"], m["sample_size_total"]))
        if step.reducer is not None:
            early.append(step.reducer.started_early)
        if grads is None:
            grads = gather_state_dict(model, {n: p.grad.detach().clone()
                                              for n, p in model.named_parameters()})
    final = gather_state_dict(model, {n: p.detach().clone() for n, p in model.named_parameters()})
    out = {"metrics": metrics, "grads": {k: v.numpy() for k, v in grads.items()},
           "params": {k: v.numpy() for k, v in final.items()},
           # the batches of each path of shard_batch in these updates
           "paths": {k: n - before.get(k, 0) for k, n in BATCH_PATHS.items()
                     if n != before.get(k, 0)},
           # the gradient buckets that started their all-reduce during the
           # backward, in each update, and the buckets
           "early": early, "buckets": 0 if step.reducer is None else len(step.reducer.buckets)}
    if zero:
        # the moments each rank keeps: a slice, not the whole parameter
        shard = opt.shards[[n for n, _ in model.named_parameters()].index(
            "decoder.embed_tokens.weight")]
        out["zero_slice"] = tuple(shard.shape)
        out["optax"] = opt.state_to_optax(model, step.num_updates)
    return out


def mt_update(state_dict, mt_cfg: dict, batch, mesh=None):
    """One Adam update of a tiny ``transformer`` (label-smoothed CE), its
    encoder and decoder stacks through the GPipe schedule where ``mesh``
    has pipe ranks -> (loss, gnorm), the normalised gradients."""
    from chimera_st_tpu_torch import criterions  # noqa: F401
    from chimera_st_tpu_torch.config.registry import CRITERIONS
    from chimera_st_tpu_torch.models.transformer_mt import build_transformer
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.train import TrainStep

    cfg = dict(mt_cfg)
    if mesh is not None:
        cfg.update(pipeline_stages=2, pipeline_chunks=2, pipeline_mesh=mesh)
    model = build_transformer(cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    model.train()
    step = TrainStep(model, CRITERIONS.get("label_smoothed_cross_entropy")(
        {"padding_idx": 1, "label_smoothing": 0.1}), build_optimizer(OPT, model.parameters()),
        build_lr_schedule(SCHED), compute_dtype=torch.float32, mesh=mesh, pad=1)
    m = step([batch])
    return (m["loss"], m["gnorm"]), {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def decode_batch(state_dict, mt_cfg: dict, src: np.ndarray, mesh=None):
    """Beam 3 over a text batch of a tiny ``transformer``, split over the
    data ranks and gathered as ``cli.generate`` does -> tokens, scores,
    lengths of the whole batch, and whether the ranks split it."""
    from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
    from chimera_st_tpu_torch.models.transformer_mt import build_transformer
    from chimera_st_tpu_torch.parallel.partition import gather_rows, split_batch

    model = build_transformer(mt_cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    gen = SequenceGenerator(model.eval(), GeneratorSettings(beam_size=3, max_decode_len=10,
                                                            min_len=2))
    part, sliced = split_batch({"src_tokens": src}, mesh)
    tokens, scores, lens = (x.numpy() for x in gen.generate_text(
        torch.from_numpy(part["src_tokens"]).long()))
    if sliced:
        tokens, scores, lens = gather_rows(mesh, tokens, scores, lens, pad_value=1)
    return tokens, scores, lens, sliced


def ring(q, k, v, pad, r, mesh):
    """This rank's block of ring attention, and the gradients of
    sum(out * r) for its blocks, gathered over the ranks in order."""
    from chimera_st_tpu_torch.parallel.ring_attention import ring_self_attention

    n, i = mesh.shape["seq"], mesh.index("seq")
    tl = q.shape[1] // n
    blk = slice(i * tl, (i + 1) * tl)
    qb, kb, vb = (torch.from_numpy(np.ascontiguousarray(x[:, blk])).requires_grad_()
                  for x in (q, k, v))
    out = ring_self_attention(qb, kb, vb, mesh, torch.from_numpy(pad[:, blk]))
    (out * torch.from_numpy(np.ascontiguousarray(r[:, blk]))).sum().backward()
    parts = [None] * n
    dist.all_gather_object(parts, [out.detach().numpy(), qb.grad.numpy(), kb.grad.numpy(),
                                   vb.grad.numpy()], group=mesh.group("seq"))
    return [np.concatenate([p[j] for p in parts], axis=1) for j in range(4)]


def run(rank: int, directory: str) -> None:
    from chimera_st_tpu_torch.parallel import reducer
    from chimera_st_tpu_torch.parallel.mesh import Mesh, make_mesh, make_pipeline_mesh

    # buckets of 4 KB, so that the tiny models' gradients fill many
    reducer.BUCKET_BYTES = 1 << 12

    inputs = pickle.loads((Path(directory) / "inputs.pkl").read_bytes())
    out = {}
    lm, batches = inputs["lm"], inputs["batches"]
    out["data4"] = train_updates("transformer_lm", lm, batches, make_mesh(4, 1))
    tp = make_mesh(2, 2)
    out["tp"] = train_updates("transformer_lm", lm, batches, tp)
    out["tp_zero"] = train_updates("transformer_lm", lm, batches, tp, zero=True)
    out["zero4"] = train_updates("transformer_lm", lm, batches, make_mesh(4, 1), zero=True)
    pipe = make_pipeline_mesh(2)
    out["pipe"] = train_updates("transformer_lm_pipe", inputs["lm_pipe"], batches, pipe,
                                pipeline=dict(pipeline_stages=2, pipeline_chunks=4,
                                              pipeline_mesh=pipe))
    out["mt_pipe"] = mt_update(inputs["mt"], inputs["mt_cfg"], inputs["mt_batch"], pipe)
    out["ring"] = ring(*inputs["ring"], Mesh({"seq": 4}))
    out["decode"] = decode_batch(inputs["mt"], inputs["mt_cfg"], inputs["src"], make_mesh(4, 1))
    if rank == 0:
        (Path(directory) / "results.pkl").write_bytes(pickle.dumps(out))


def rank_main(rank: int, directory: str) -> None:
    """A spawned rank: one thread, joined to the world of 4 through a file
    in ``directory``."""
    from chimera_st_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{directory}/rendezvous", 4, rank, device="cpu")
    try:
        run(rank, directory)
    finally:
        dist.destroy_process_group()


def grid_rank(rank: int, directory: str, flag_sets) -> None:
    """A rank of a world of 2: the train CLI's grid for each flag set
    (``options.setup_mesh``); rank 0 writes their shapes to ``grids.pkl``."""
    from chimera_st_tpu_torch.cli import options
    from chimera_st_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{directory}/rendezvous", 2, rank, device="cpu")
    try:
        shapes = []
        for flags in flag_sets:
            p = options.base_parser("train")
            options.add_train_args(p)
            args, _ = options.parse_with_model_overrides(p, ["data", "--cpu", *flags])
            options.require_ported(args, options.TRAIN_UNPORTED)
            shapes.append(options.setup_mesh(args, "cpu").shape)
        if rank == 0:
            (Path(directory) / "grids.pkl").write_bytes(pickle.dumps(shapes))
    finally:
        dist.destroy_process_group()
