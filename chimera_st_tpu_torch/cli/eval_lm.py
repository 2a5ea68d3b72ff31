"""Language-model perplexity (counterpart of chimera_st_tpu/cli/eval_lm.py;
reference fairseq_cli/eval_lm.py), with the same last line:
``Evaluated N tokens: loss L bits/token, perplexity P``.

    python -m chimera_st_tpu_torch.cli.eval_lm DATA_BIN --path lm.ckpt \\
        --gen-subset test --tokens-per-sample 512 --context-window 256

``DATA_BIN`` holds ``dict.txt`` and ``{split}.bin/idx`` (``chimera-torch-
preprocess --only-source``). ``--context-window C`` evaluates blocks of
``tokens-per-sample - C`` tokens, each behind the C tokens that precede it,
whose loss is not counted (fairseq's LMContextWindowDataset).

The LM's forward is causal, and K1 covers bidirectional attention only (the
Pallas kernel's gate ``flash_attention_applicable``): on the card this CLI
launches no hand-written kernel, as the JAX CLI runs no Pallas kernel. The
model runs on ``--device`` (default ``cuda``; ``cpu`` for the plain
path)."""

from __future__ import annotations

import logging
import math
import sys

logger = logging.getLogger("chimera_st_tpu_torch.eval_lm")


def main(argv=None) -> dict:
    """Prints the loss line; returns {"tokens", "loss_bits", "perplexity",
    "load_s", "eval_s"} (host-clock seconds)."""
    from . import options

    p = options.base_parser("chimera-eval-lm (PyTorch port)")
    p.add_argument("--path", required=True)
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--tokens-per-sample", type=int, default=512)
    p.add_argument("--sample-break-mode", default="none")
    p.add_argument("--context-window", type=int, default=0,
                   help="sliding-window evaluation: each block sees this many tokens of "
                        "preceding context whose loss is not counted")
    args, model_overrides = options.parse_with_model_overrides(p, argv)
    options.require_ported(args)
    options.require_single_host(args, "chimera-eval-lm")
    device = options.resolve_device(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s | %(message)s")

    import time

    import numpy as np
    import torch

    from ..criterions.label_smoothed_ce import ce_loss_from_logits
    from ..tasks import setup_task
    from .generate import load_language_model, to_device, torch_dtype

    ctx = max(args.context_window, 0)
    if ctx and args.sample_break_mode not in ("none", None):
        raise ValueError("--context-window needs --sample-break-mode none")
    # blocks shrink so that block + context fits tokens_per_sample
    task = setup_task({"_name": "language_modeling", "data": args.data,
                       "tokens_per_sample": args.tokens_per_sample - ctx,
                       "sample_break_mode": args.sample_break_mode})
    task.load_dataset(args.gen_subset)

    t0 = time.time()
    model = load_language_model(args.path, task, torch_dtype(args.dtype), device,
                                model_overrides)
    load_s = time.time() - t0
    pad = task.target_dictionary.pad()

    itr = task.make_batch_iterator(
        task.dataset(args.gen_subset),
        max_tokens=int(args.max_tokens) if args.max_tokens else None,
        max_sentences=args.batch_size or 8,
        num_length_buckets=args.num_length_buckets,
    ).next_epoch_itr(shuffle=False)

    t0 = time.time()
    total_nll, total_tokens = 0.0, 0
    # the context tail rolls across the ordered blocks; context positions
    # get pad targets, so their loss is not counted
    carry = np.full((ctx,), pad, np.int64) if ctx else None
    with torch.inference_mode(), options.profiled(args):
        for batch in itr:
            nt = np.asarray(batch["net_tokens"])
            tg = np.asarray(batch["target"])
            if ctx:
                ctxs = np.empty((nt.shape[0], ctx), tg.dtype)
                for j in range(nt.shape[0]):
                    ctxs[j] = carry if j == 0 else tg[j - 1, -ctx:]
                carry = tg[-1, -ctx:]
                nt = np.concatenate([ctxs, nt], axis=1)
                tg = np.concatenate([np.full((nt.shape[0], ctx), pad, tg.dtype), tg], axis=1)
            logits = model(to_device(nt, device).long())
            _, nll = ce_loss_from_logits(logits, to_device(tg, device).long(), 0.0, pad)
            total_nll += float(nll)
            total_tokens += int(batch["ntokens"])
    eval_s = time.time() - t0
    nll_per_tok = total_nll / max(total_tokens, 1) / math.log(2)
    print(f"Evaluated {total_tokens} tokens: loss {nll_per_tok:.4f} bits/token, "
          f"perplexity {2 ** nll_per_tok:.2f}")
    return {"tokens": total_tokens, "loss_bits": nll_per_tok, "perplexity": 2 ** nll_per_tok,
            "load_s": load_s, "eval_s": eval_s}


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
