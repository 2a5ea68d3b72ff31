"""Validation over a split with a checkpoint (counterpart of
chimera_st_tpu/cli/validate.py: the same flags and the same output line).

    python -m chimera_st_tpu_torch.cli.validate DATA_DIR --task triplet \\
        --path checkpoint_best.ckpt --valid-subset dev_wave \\
        --criterion triplet_st_mt_contrastive --label-smoothing 0.1

``--path`` takes a native ``.ckpt`` (either package's trainer) or a fairseq
``.pt`` of the interlingua model; ``--task translation`` validates an MT
checkpoint on binarized text. A native checkpoint keeps the arch stored in
it unless ``--arch`` is given (the JAX CLI replaces it with ``--arch``'s
default, so a ``transformer`` checkpoint fails there without the flag),
and the undeclared flags (``--langs``, ``--lang-pairs``) reach the task as
in generate (the JAX CLI drops them). Prints one line of the losses over the
sample size in bits, ``loss 1.2345 | st_loss 1.2345 | …``, and returns them.
``--dump-feature-to-file FILE`` pickles, for a task with ``dump_memories``
(triplet), a list with one dict a batch: the audio and text memory banks
(numpy, fp32 whatever ``--dtype``) and the batch's sample ids.
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
    # a native checkpoint keeps its stored arch unless --arch is given (the
    # JAX CLI replaces it with the parser's default; ROADMAP C)
    p.set_defaults(arch=None)
    args, model_overrides = options.parse_with_model_overrides(p, argv)
    options.require_ported(args)
    options.require_single_host(args, "chimera-validate")
    device = options.resolve_device(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s | %(message)s")

    import numpy as np
    import torch

    from ..tasks import setup_task
    from ..train.train_step import prepare_batch, valid_step
    from .generate import load_model_and_params, torch_dtype

    # the undeclared flags (--langs, --lang-pairs, --num-classes ...) reach
    # the task, as in generate and train (the JAX CLI drops them; ROADMAP C)
    task_cfg = {"_name": args.task, "data": args.data, "config_yaml": args.config_yaml,
                "source_lang": args.source_lang, "target_lang": args.target_lang,
                **model_overrides}
    task = setup_task(task_cfg)
    task.load_dataset(args.valid_subset)

    if args.arch is not None:
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
    dumped = []
    dump = args.dump_feature_to_file and hasattr(task, "dump_memories")
    with torch.inference_mode(), options.profiled(args):
        for batch in itr:
            ids = batch.get("id")
            batch = prepare_batch({k: v for k, v in batch.items() if k != "id"}, device)
            for k, v in valid_step(model, criterion, batch).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            if dump:
                mem = task.dump_memories(model, batch)
                mem["id"] = None if ids is None else np.asarray(ids)
                dumped.append(mem)
    if dumped:
        import pickle

        with open(args.dump_feature_to_file, "wb") as f:
            pickle.dump(dumped, f)
        logger.info(f"dumped {len(dumped)} batches of memory features to "
                    f"{args.dump_feature_to_file}")
    ss = max(totals.get("sample_size", 1.0), 1.0)
    stats = {k: v / ss / math.log(2) for k, v in totals.items() if k.endswith("loss")}
    print(" | ".join(f"{k} {v:.4f}" for k, v in sorted(stats.items())))
    return stats


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
