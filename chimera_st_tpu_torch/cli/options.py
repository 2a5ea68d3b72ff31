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
from typing import Any, Dict, Tuple

from ..generation import generator


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


# what the entry points cannot do yet: the generator's own list, and
# several processes or cards (attribute, test on its value, flag, ROADMAP item)
UNPORTED = generator.UNPORTED + (
    ("distributed_world_size", lambda v: v > 1, "--distributed-world-size above 1", "A12"),
    ("distributed_init_method", bool, "--distributed-init-method", "A12"),
    ("model_parallel_size", lambda v: v > 1, "--model-parallel-size above 1", "A12"),
)


def require_ported(args) -> None:
    """Raises for the first option of ``UNPORTED`` that ``args`` sets."""
    generator.require_ported(args, UNPORTED)


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
    """Parse known args; fold leftover --flag[=]value pairs into a dict."""
    args, leftover = p.parse_known_args(argv)
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
