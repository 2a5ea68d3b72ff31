"""Validation over a split with a checkpoint (counterpart of
chimera_st_tpu/cli/validate.py: the same flags and the same output line).

    python -m chimera_st_tpu_torch.cli.validate DATA_DIR --task triplet \\
        --path checkpoint_best.ckpt --valid-subset dev_wave \\
        --criterion triplet_st_mt_contrastive --label-smoothing 0.1

``--path`` takes a native ``.ckpt`` (either package's trainer) or a fairseq
``.pt`` of the interlingua model. Prints one line of the losses over the
sample size in bits, ``loss 1.2345 | st_loss 1.2345 | …``, and returns them.
``--dump-feature-to-file`` (the memory banks of each batch) is not ported
(ROADMAP A10b).
"""

from __future__ import annotations

import logging
import math
import sys

logger = logging.getLogger("chimera_st_tpu_torch.validate")


def main(argv=None) -> dict:
    from . import options

    p = options.base_parser("chimera-validate (PyTorch port)")
    options.add_train_args(p)
    p.add_argument("--path", required=True)
    p.add_argument("--dump-feature-to-file", default=None, metavar="FILE")
    args, model_overrides = options.parse_with_model_overrides(p, argv)
    options.require_ported(args)
    if args.dump_feature_to_file:
        raise NotImplementedError("--dump-feature-to-file is not ported yet (ROADMAP A10b)")
    device = options.resolve_device(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s | %(message)s")

    import torch

    from ..tasks import setup_task
    from ..train.train_step import prepare_batch, valid_step
    from .generate import load_model_and_params, torch_dtype

    task_cfg = {"_name": args.task, "data": args.data, "config_yaml": args.config_yaml,
                "source_lang": args.source_lang, "target_lang": args.target_lang}
    task = setup_task(task_cfg)
    task.load_dataset(args.valid_subset)

    model_overrides.setdefault("arch", args.arch)
    model = load_model_and_params(args.path, task, torch_dtype(args.dtype), device,
                                  model_overrides)
    criterion = task.build_criterion({
        "_name": args.criterion,
        "label_smoothing": args.label_smoothing,
        "loss_ratio": tuple(args.loss_ratio),
    })
    itr = task.make_batch_iterator(
        task.dataset(args.valid_subset),
        max_tokens=int(args.max_tokens) if args.max_tokens else None,
        max_sentences=args.batch_size,
        num_length_buckets=args.num_length_buckets,
    ).next_epoch_itr(shuffle=False)
    totals = {}
    with torch.inference_mode():
        for batch in itr:
            batch = {k: v for k, v in batch.items() if k != "id"}
            for k, v in valid_step(model, criterion, prepare_batch(batch, device)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
    ss = max(totals.get("sample_size", 1.0), 1.0)
    stats = {k: v / ss / math.log(2) for k, v in totals.items() if k.endswith("loss")}
    print(" | ".join(f"{k} {v:.4f}" for k, v in sorted(stats.items())))
    return stats


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
