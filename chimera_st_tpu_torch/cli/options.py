"""CLI argument parsing (counterpart of chimera_st_tpu/cli/options.py: the
base parser and the generation arguments, with the same flags and defaults so
that the recipes' command lines parse, plus ``--device``).

Core flags are declared explicitly; any unrecognized ``--some-flag value``
pairs are folded into the model config dict. An option whose feature is not
ported yet is parsed and then refused by ``require_ported`` with a
``NotImplementedError`` that names the ROADMAP item: none is accepted and
ignored."""

from __future__ import annotations

import argparse
import ast
import contextlib
from typing import Any, Dict, Tuple

from ..generation import generator
from ..models import ZOO_ARCHITECTURES
from ..models.s2t_transformer import ARCHITECTURES as S2T_ARCHITECTURES


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("data", nargs="?", help="data directory")
    p.add_argument("--task", default="triplet")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--log-format", default=None)
    p.add_argument("--tensorboard-logdir", default=None)
    p.add_argument("--config-yaml", default="config_wave.yaml")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--fp16", action="store_true",
                   help="accepted for recipe compat; the compute dtype is --dtype")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs: the card (through the CUDA kernels; "
                        "raises without one) or the CPU (through their plain "
                        "PyTorch versions)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--max-tokens", type=float, default=None)
    p.add_argument("--batch-size", "--max-sentences", type=int, default=None)
    p.add_argument("--required-batch-size-multiple", type=int, default=1)
    p.add_argument("--num-length-buckets", type=int, default=10)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--shard-id", type=int, default=0)
    p.add_argument("--model-parallel-size", type=int, default=1)
    p.add_argument("--distributed-world-size", type=int, default=-1,
                   help="number of devices to use (-1: one)")
    p.add_argument("--distributed-init-method", default=None)
    p.add_argument("--distributed-rank", type=int, default=None)
    p.add_argument("--distributed-num-procs", type=int, default=None)
    p.add_argument("--source-lang", "-s", default=None)
    p.add_argument("--target-lang", "-t", default=None)
    p.add_argument("--max-source-positions", type=int, default=6000000)
    p.add_argument("--max-target-positions", type=int, default=1024)
    p.add_argument("--skip-invalid-size-inputs-valid-test", action="store_true")
    p.add_argument("--zero-sharding", default="none", choices=["none", "os"],
                   help="'os': shard optimizer state over the data axis (ZeRO-1)")
    p.add_argument("--pipeline-stages", type=int, default=0)
    p.add_argument("--pipeline-chunks", type=int, default=0)
    p.add_argument("--pipeline-checkpoint", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR")
    p.add_argument("--user-dir", default=None, metavar="DIR",
                   help="a module whose import registers custom tasks/models/criterions")
    return p


def add_train_args(p: argparse.ArgumentParser):
    """The JAX train parser's flags and defaults, so that the recipes parse;
    ``TRAIN_UNPORTED`` refuses those whose feature is not ported."""
    p.add_argument("--arch", "-a", default="s2t_transformer_w2v2_interlingua_base")
    p.add_argument("--criterion", default="label_smoothed_cross_entropy")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--loss-ratio", type=float, nargs="+", default=[1.0, 1.0, 1.0])
    p.add_argument("--contrastive-temp", type=float, default=0.1)
    p.add_argument("--contrastive-increase-until", type=int, default=None)
    p.add_argument("--sentence-avg", action="store_true")
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--adam-betas", default="(0.9, 0.999)")
    p.add_argument("--adam-eps", type=float, default=1e-8)
    # the other optimizers' and schedules' knobs (read where theirs is chosen)
    p.add_argument("--momentum", type=float, default=0.0)
    p.add_argument("--adagrad-eps", type=float, default=1e-10)
    p.add_argument("--adadelta-rho", type=float, default=0.9)
    p.add_argument("--adadelta-eps", type=float, default=1e-6)
    p.add_argument("--adamax-betas", default=None)
    p.add_argument("--adamax-eps", type=float, default=1e-8)
    p.add_argument("--lamb-betas", default=None)
    p.add_argument("--lamb-eps", type=float, default=1e-8)
    p.add_argument("--weight-decay", "--wd", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--lr", type=str, default="0.25")
    p.add_argument("--lr-scheduler", default="fixed")
    p.add_argument("--warmup-updates", type=int, default=0)
    p.add_argument("--warmup-init-lr", type=float, default=-1)
    p.add_argument("--total-num-update", type=int, default=0)
    p.add_argument("--end-learning-rate", type=float, default=0.0)
    p.add_argument("--power", type=float, default=1.0)
    p.add_argument("--min-lr", type=float, default=None)
    p.add_argument("--max-lr", type=float, default=None)
    p.add_argument("--lr-period-updates", type=float, default=None)
    p.add_argument("--t-mult", type=float, default=1.0)
    p.add_argument("--lr-shrink", type=float, default=0.1)
    p.add_argument("--init-lr-scale", type=float, default=0.01)
    p.add_argument("--final-lr-scale", type=float, default=0.01)
    p.add_argument("--phase-ratio", type=str, default=None)
    # parsed and unused in the JAX trainer too
    p.add_argument("--stop-min-lr", type=float, default=-1.0)
    p.add_argument("--update-freq", type=str, default="1")
    p.add_argument("--async-dispatch", type=int, default=3,
                   help="updates kept in flight with deferred metrics, read and "
                        "logged at the next log / save / stop boundary (0: read after "
                        "every update)")
    p.add_argument("--max-update", type=int, default=0)
    p.add_argument("--max-epoch", type=int, default=0)
    p.add_argument("--stop-time-hours", type=float, default=0)
    p.add_argument("--train-subset", default="train")
    p.add_argument("--valid-subset", default="valid")
    p.add_argument("--validate-interval", type=int, default=1)
    p.add_argument("--validate-interval-updates", type=int, default=0,
                   help="parsed and unused, as in the JAX trainer")
    p.add_argument("--disable-validation", action="store_true")
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--restore-file", default="checkpoint_last.ckpt")
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--reset-dataloader", action="store_true")
    p.add_argument("--reset-lr-scheduler", action="store_true")
    p.add_argument("--reset-meters", action="store_true")
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--save-interval-updates", type=int, default=0)
    p.add_argument("--keep-last-epochs", type=int, default=-1)
    p.add_argument("--keep-interval-updates", type=int, default=-1)
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--no-epoch-checkpoints", action="store_true")
    p.add_argument("--best-checkpoint-metric", default="loss")
    p.add_argument("--maximize-best-checkpoint-metric", action="store_true")
    p.add_argument("--patience", type=int, default=-1)
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--max-tokens-valid", type=float, default=None)
    p.add_argument("--batch-size-valid", type=int, default=None)
    p.add_argument("--validate-after-updates", type=int, default=0)
    p.add_argument("--fixed-validation-seed", type=int, default=None)
    p.add_argument("--curriculum", type=int, default=0)
    p.add_argument("--keep-best-checkpoints", type=int, default=-1)
    p.add_argument("--no-last-checkpoints", action="store_true")
    p.add_argument("--no-save-optimizer-state", action="store_true")
    p.add_argument("--finetune-from-model", default=None, metavar="CKPT")
    p.add_argument("--optimizer-overrides", default="{}",
                   help="accepted for recipe compat: optimizer hyperparameters "
                        "always come from the current arguments")
    p.add_argument("--data-buffer-size", type=int, default=4)
    p.add_argument("--no-host-wire", action="store_true",
                   help="send the train split's audio as float32 with its padding mask "
                        "(default: PCM16 as int16 and no mask, both rebuilt on the device)")
    p.add_argument("--ddp-backend", default=None, help="accepted for recipe compat")
    p.add_argument("--task-configs", nargs="+", default=None)
    p.add_argument("--main-task", default=None)
    p.add_argument("--fix-wav2vec", action="store_true")
    p.add_argument("--fix-interlingua", action="store_true")
    p.add_argument("--fix-decoder", action="store_true")
    p.add_argument("--fix-decoder-transformers", action="store_true")
    p.add_argument("--fix-encoder-transformers", action="store_true")
    p.add_argument("--reset-encoder", action="store_true")
    p.add_argument("--feature-grad-mult", type=float, default=1.0)
    return p


def add_generation_args(p: argparse.ArgumentParser):
    p.add_argument("--path", default=None, help="checkpoint path(s), ':' separated (ensemble)")
    p.add_argument("--lm-path", default=None, help="language model checkpoint for shallow fusion")
    p.add_argument("--lm-weight", type=float, default=0.0)
    p.add_argument("--ctc-lm-path", default=None,
                   help="ARPA n-gram LM for CTC prefix-beam fusion (wav2vec_ctc decode)")
    p.add_argument("--ctc-lm-weight", type=float, default=1.0)
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--max-len-a", type=float, default=0)
    p.add_argument("--max-len-b", type=int, default=200)
    p.add_argument("--min-len", type=int, default=1)
    p.add_argument("--min-len-a", type=float, default=0.0,
                   help="per-sentence min length = a*src_len + b (reference: "
                        "search.py:526 LengthConstrainedBeamSearch)")
    p.add_argument("--min-len-b", type=int, default=0)
    p.add_argument("--lenpen", type=float, default=1)
    p.add_argument("--unkpen", type=float, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--max-decode-len", type=int, default=256)
    p.add_argument("--prefix-size", type=int, default=0)
    p.add_argument("--no-repeat-ngram-size", type=int, default=0)
    p.add_argument("--diverse-beam-groups", type=int, default=-1)
    p.add_argument("--diverse-beam-strength", type=float, default=0.5)
    p.add_argument("--sampling", action="store_true")
    p.add_argument("--sampling-topk", type=int, default=-1)
    p.add_argument("--sampling-topp", type=float, default=-1.0)
    p.add_argument("--iter-decode-max-iter", type=int, default=None,
                   help="refinement iterations for NAT models "
                        "(reference iterative_refinement_generator max_iter)")
    p.add_argument("--iter-decode-force-max-iter", action="store_true",
                   help="disable the NAT early exit; always run max_iter "
                        "rounds (reference iterative_refinement_generator)")
    p.add_argument("--iter-decode-eos-penalty", type=float, default=0.0,
                   help="Levenshtein: penalty on predicting ZERO insertions "
                        "per slot — discourages short outputs (reference "
                        "levenshtein_transformer.py forward_decoder "
                        "mask_ins_score[...,0] -= eos_penalty)")
    p.add_argument("--iter-decode-with-beam", type=int, default=1,
                   help="NAT length-beam: decode the top-B predicted lengths "
                        "in parallel and keep the best-scoring candidate "
                        "(reference iterative_refinement_generator beam_size)")
    p.add_argument("--iter-decode-with-external-reranker", action="store_true",
                   help="NAT: teacher-force-score every length-beam candidate "
                        "with the LAST --path checkpoint (an autoregressive "
                        "seq2seq model) and keep the best mean token log-prob "
                        "(reference iterative_refinement_generator.py rerank; "
                        "requires --iter-decode-with-beam > 1)")
    p.add_argument("--retain-iter-history", action="store_true",
                   help="NAT: record the canvas after every refinement round "
                        "and print them as E-<id>_<step> lines (reference "
                        "retain_history / generate.py:331)")
    p.add_argument("--print-step", action="store_true",
                   help="print the refinement step each NAT hypothesis "
                        "finalized at as I-<id> (reference generate.py:325)")
    p.add_argument("--diversity-rate", type=float, default=-1.0,
                   help="diverse-siblings rank penalty (reference search.py:745)")
    p.add_argument("--match-source-len", action="store_true",
                   help="pin hypothesis length to the source length "
                        "(reference sequence_generator.py match_source_len; "
                        "maps to per-sentence min/max = 1*src_len)")
    p.add_argument("--unnormalized", action="store_true",
                   help="rank hypotheses by raw log-prob sum instead of "
                        "length-normalized score (reference --unnormalized; "
                        "equivalent to lenpen 0)")
    p.add_argument("--kv-cache-int8", action="store_true",
                   help="store decode self-attention K/V caches as int8 with "
                        "per-row f32 scales")
    p.add_argument("--retain-dropout", action="store_true",
                   help="keep dropout active through encode and the beam "
                        "decode: seed-reproducible MC-sampled hypotheses")
    p.add_argument("--score-reference", action="store_true",
                   help="score gold targets instead of searching "
                        "(reference fairseq_cli/generate.py --score-reference)")
    p.add_argument("--replace-unk", nargs="?", const=True, default=None,
                   metavar="ALIGN_DICT",
                   help="replace hypothesis <unk> via cross-attention argmax; "
                        "optional src->tgt lexicon file (reference utils.replace_unk)")
    p.add_argument("--print-alignment", action="store_true",
                   help="emit A- lines: per-target-token source argmax of the "
                        "last decoder layer's head-averaged cross-attention "
                        "(reference: SequenceGeneratorWithAlignment)")
    p.add_argument("--remove-bpe", "--post-process", dest="remove_bpe",
                   nargs="?", const="subword_nmt", default=None)
    p.add_argument("--scoring", default="sacrebleu")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--results-path", default=None)
    return p


# the generation and validation CLIs refuse the generator's own list
UNPORTED = generator.UNPORTED


# the zoo's models that the JAX train CLI cannot initialise: its
# init_params_for_task (chimera_st_tpu/cli/train.py:490-553) has no branch
# for them and falls through to the interlingua model's init (ROADMAP C3);
# they train through ``train.TrainStep``, as the JAX tests train them
ZOO_CLI_UNTRAINED = frozenset(
    arch for arch, (model, _) in ZOO_ARCHITECTURES.items()
    if model not in ("fconv_lm", "lightconv_lm", "lstm_lm", "rnn_classifier"))
# the train CLI's
TRAIN_UNPORTED = (
    ("task", lambda v: v == "speech_to_text",
     "--task speech_to_text (fbank training; the JAX train CLI cannot train this model "
     "either: its init_params_for_task has no S2T branch, ROADMAP C)", "A10c"),
    ("arch", lambda v: v in S2T_ARCHITECTURES,
     "--arch of the fbank s2t_transformer presets (the JAX train CLI cannot train this "
     "model either, ROADMAP C)", "A10c"),
    ("arch", lambda v: v in ZOO_CLI_UNTRAINED,
     "--arch of the encoder-decoder zoo, s2t_berard or dummy_model (the JAX train CLI "
     "cannot initialise these models; train them through train.TrainStep)", "C3"),
)


def _distributed_args(args) -> Tuple[Any, Any, Any]:
    """(init method, rank, process count) of the ``--distributed-*`` flags,
    with the JAX CLI's errors (``chimera_st_tpu/cli/options.py:325-352``);
    without rank and count, torchrun's ``RANK`` / ``WORLD_SIZE``."""
    import os

    init = getattr(args, "distributed_init_method", None)
    rank = getattr(args, "distributed_rank", None)
    nprocs = getattr(args, "distributed_num_procs", None)
    if init is None:
        if rank is not None or nprocs is not None:
            raise SystemExit("--distributed-rank/--distributed-num-procs have no effect "
                             "without --distributed-init-method tcp://HOST:PORT")
        return None, None, None
    if (rank is None) != (nprocs is None):
        raise SystemExit("give --distributed-rank and --distributed-num-procs together, or "
                         f"neither (then RANK / WORLD_SIZE); got rank={rank} "
                         f"num_procs={nprocs}")
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise SystemExit("--distributed-init-method needs --distributed-rank and "
                             "--distributed-num-procs (or RANK and WORLD_SIZE)")
        rank, nprocs = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    from ..parallel.mesh import parse_init_method

    return parse_init_method(init), rank, nprocs


def spawn_ranks(args, device: str, fn, argv) -> bool:
    """``--distributed-world-size N`` (N > 1) without an init method, in a
    process that is not a rank yet: starts N ranks of ``fn(rank, argv)`` on
    this host (one a card; gloo on the CPU) and waits for them -> True.
    Otherwise False (this process runs the program)."""
    import torch.distributed as dist

    n = getattr(args, "distributed_world_size", -1)
    if n <= 1 or getattr(args, "distributed_init_method", None) or dist.is_initialized():
        return False
    from ..parallel.mesh import spawn

    spawn(fn, n, argv, device=device)
    return True


def setup_mesh(args, device: str):
    """Joins the world of ``--distributed-init-method`` (rank
    ``--distributed-rank`` of ``--distributed-num-procs``) unless this
    process already is a rank, then -> the rank grid: data x
    ``--pipeline-stages`` or data x ``--model-parallel-size``; None for one
    process that asks for no grid."""
    import torch.distributed as dist

    from ..parallel import mesh as mesh_mod

    init, rank, nprocs = _distributed_args(args)
    if init is not None and not dist.is_initialized():
        mesh_mod.initialize_distributed(init, nprocs, rank, device)
    stages = getattr(args, "pipeline_stages", 0)
    tp = getattr(args, "model_parallel_size", 1)
    if stages > 1 and tp > 1:
        raise SystemExit("--pipeline-stages and --model-parallel-size are mutually exclusive "
                         "(the pipe mesh has no model axis); pick one")
    if not dist.is_initialized() and stages <= 1 and tp <= 1:
        return None
    if stages > 1:
        return mesh_mod.make_pipeline_mesh(stages)
    return mesh_mod.make_mesh(model_parallel=tp)


def setup_data_mesh(args, device: str):
    """The decode CLI's grid: every rank a data rank (``generate`` shards
    each batch over them, as the JAX CLI shards it over its devices); the
    training-only grid flags do not reach a decode, as in JAX. None for one
    process."""
    import torch.distributed as dist

    from ..parallel import mesh as mesh_mod

    init, rank, nprocs = _distributed_args(args)
    if init is not None and not dist.is_initialized():
        mesh_mod.initialize_distributed(init, nprocs, rank, device)
    return mesh_mod.make_mesh() if dist.is_initialized() else None


def require_single_host(args, entry_point: str) -> None:
    """The JAX decode CLIs' refusal of a job of several processes
    (``chimera_st_tpu/cli/options.py:356-376``): run one job a data shard."""
    _, _, nprocs = _distributed_args(args)
    if nprocs is not None and nprocs > 1:
        raise SystemExit(
            f"{entry_point} does not support several processes: it writes a single results "
            "file. Run one job per data shard (--num-shards / --shard-id) instead.")


def require_ported(args, table=UNPORTED) -> None:
    """Raises for the first option of ``table`` that ``args`` sets."""
    generator.require_ported(args, table)


@contextlib.contextmanager
def profiled(args):
    """``--profile DIR``: a torch.profiler trace of the block in DIR (a
    Chrome trace, ``trace.json``), host and, on the card, device. Every CLI
    wraps its main loop in it (the JAX package's CLIs other than train
    accept the flag and ignore it)."""
    if not getattr(args, "profile", None):
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))


def parse_lr(lr_str: str) -> float:
    """'--lr 5e-4' or '--lr 0.25,0.1' -> the first value."""
    return float(str(lr_str).split(",")[0])


def parse_update_freq(s: str) -> int:
    return int(str(s).split(",")[0])


def resolve_device(args) -> str:
    """``--device`` (``--cpu`` = cpu). The card is never swapped for the
    CPU silently: ``cuda`` without a card raises."""
    device = "cpu" if args.cpu else args.device
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run the plain PyTorch versions)")
    return device


def parse_with_model_overrides(
    p: argparse.ArgumentParser, argv=None
) -> Tuple[argparse.Namespace, Dict[str, Any]]:
    """Parse known args; fold leftover --flag[=]value pairs into a dict.
    ``--user-dir`` is imported first, so that its registrations are there
    for what follows."""
    args, leftover = p.parse_known_args(argv)
    if getattr(args, "user_dir", None):
        import_user_module(args.user_dir)
    extra: Dict[str, Any] = {}
    i = 0
    while i < len(leftover):
        tok = leftover[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unrecognized argument: {tok}")
        key = tok[2:]
        val: Any = True
        if "=" in key:
            key, val = key.split("=", 1)
        elif i + 1 < len(leftover) and not leftover[i + 1].startswith("--"):
            val = leftover[i + 1]
            i += 1
        if isinstance(val, str):
            try:
                val = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                pass
        extra[key.replace("-", "_")] = val
        i += 1
    return args, extra


def import_user_module(path: str) -> None:
    """Imports a plugin module or package so that its ``register_*``
    decorators run (JAX ``cli/options.py:420-458``; fairseq
    ``utils.import_user_module``): the port's own registries are filled
    first, then ``path``'s directory goes on ``sys.path`` for the import of
    its name. A name already imported from another place raises
    ``ImportError``, since the import would silently do nothing."""
    import importlib
    import os
    import sys

    from .. import criterions, models, tasks  # noqa: F401 — registration

    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"--user-dir {path} does not exist")
    parent, name = os.path.split(path.rstrip(os.sep))
    if name.endswith(".py"):
        name = name[:-3]
    if name in sys.modules:
        existing = os.path.abspath(getattr(sys.modules[name], "__file__", "") or "")
        if (os.path.dirname(existing) != path and existing != path + ".py"
                and not existing.startswith(path + os.sep)):
            raise ImportError(f"--user-dir module name {name!r} collides with an already-"
                              f"imported module at {existing!r}; rename the plugin directory")
        return  # already imported from this very path
    sys.path.insert(0, parent)
    try:
        importlib.import_module(name)
    finally:
        sys.path.remove(parent)
