"""Training entry point (counterpart of chimera_st_tpu/cli/train.py, for
``--task triplet``, the ST fine-tune, ``--task translation`` /
``translation_tts``, the MT pre-training stage or a ``transformer*`` model,
``--task language_modeling``, a ``transformer_lm*`` model (with
``adaptive_loss`` for ``transformer_lm_wiki103``), and ``--task
joint_task_mtst --task-configs st.json mt.json --main-task st``, the joint
MT + ST fine-tune, and ``--task audio_pretraining`` (wav2vec 2.0 pre-training; with ``--labels
ltr`` the CTC or seq2seq fine-tune, ``--best-checkpoint-metric wer`` its
greedy CTC WER) / ``bimodal_pretraining`` (Chimera's two-stream
pre-training), and ``--task translation_lev`` / ``translation_ins``, the
non-autoregressive models under ``--noise levenshtein | random_mask |
full_mask`` (an undeclared flag, as ``--random-delete-max`` and
``--random-insert-max``, reaching the task and the model as in JAX) with
``levenshtein_loss``, ``nat_loss``, ``nacrf_loss`` or ``insertion_loss``,
and the masked-LM family: ``--task masked_lm`` / ``cross_lingual_lm`` /
``multilingual_masked_lm`` (``--criterion masked_lm``), ``legacy_masked_lm``
(``--criterion legacy_masked_lm``, with the next-sentence head of the
``bert*`` presets), ``translation_from_pretrained_xlm``
(``--pretrained-xlm-checkpoint``) and ``semisupervised_translation``):
the same flags, loop, checkpoints and log lines. Every
``--optimizer`` (adam, adafactor, adagrad, adadelta, sgd, nag, adamax,
lamb) and ``--lr-scheduler`` (fixed, inverse_sqrt, cosine,
polynomial_decay, tri_stage, triangular, reduce_lr_on_plateau) of the JAX
CLI, from the same flags with the same defaults.

    python -m chimera_st_tpu_torch.cli.train DATA_DIR --task triplet \\
        --arch s2t_transformer_w2v2_interlingua_base \\
        --w2v2-model-path wav2vec_small.pt \\
        --criterion triplet_st_mt_contrastive --label-smoothing 0.1 \\
        --optimizer adam --adam-betas '(0.9, 0.98)' --lr 1e-4 \\
        --lr-scheduler inverse_sqrt --warmup-updates 25000 \\
        --max-tokens 2000000 --update-freq 8 --save-dir checkpoints/st

    python -m chimera_st_tpu_torch.cli.train DATA_BIN --task translation \\
        -s en -t de --arch s2t_transformer_w2v2_interlingua_base \\
        --criterion label_smoothed_cross_entropy --label-smoothing 0.1 \\
        --optimizer adam --adam-betas '(0.9, 0.98)' --lr 5e-4 \\
        --lr-scheduler inverse_sqrt --warmup-updates 4000 \\
        --max-tokens 4096 --update-freq 8 --save-dir checkpoints/mt

    python -m chimera_st_tpu_torch.cli.train DATA_BIN --task translation \\
        -s de -t en --arch transformer_iwslt_de_en --criterion \\
        label_smoothed_cross_entropy --label-smoothing 0.1 --optimizer adam \\
        --lr 5e-4 --lr-scheduler inverse_sqrt --warmup-updates 4000 --max-tokens 4096

    python -m chimera_st_tpu_torch.cli.train LM_BIN --task language_modeling \\
        --arch transformer_lm_gpt --criterion lm_cross_entropy \\
        --tokens-per-sample 512 --optimizer adam --lr 5e-4 \\
        --lr-scheduler inverse_sqrt --warmup-updates 4000 --max-tokens 4096

    python -m chimera_st_tpu_torch.cli.train DATA_DIR --task joint_task_mtst \\
        --task-configs st.json mt.json --main-task st \\
        --arch s2t_transformer_w2v2_interlingua_base ... (the ST recipe's flags)

    python -m chimera_st_tpu_torch.cli.train MLM_BIN --task masked_lm \\
        --arch roberta_base --criterion masked_lm --tokens-per-sample 512 \\
        --sample-break-mode complete --optimizer adam --adam-betas '(0.9,0.98)' \\
        --adam-eps 1e-6 --weight-decay 0.01 --clip-norm 0.0 --lr-scheduler \\
        polynomial_decay --lr 0.0005 --total-num-update 125000 \\
        --warmup-updates 10000 --dropout 0.1 --max-sentences 16

    python -m chimera_st_tpu_torch.cli.train DATA_BIN --task translation_lev \\
        --noise levenshtein --arch levenshtein_transformer_wmt_en_de \\
        --criterion levenshtein_loss --label-smoothing 0.1 --optimizer adam \\
        --adam-betas '(0.9, 0.98)' --lr 5e-4 --lr-scheduler inverse_sqrt \\
        --warmup-updates 10000 --dropout 0.3 --max-tokens 8000

In order: the task, the model (fp32 parameters in train mode), the
schedule, the optimizer, the criterion, then the parameters (the seeded
``init_params_``, then ``--w2v2-model-path`` through
``import_wav2vec2_state_dict``, then the task's ``post_init_params``), the
``--fix-*`` freezing (a text-only task adds the audio-trunk mask unless
``--fix-wav2vec`` is given; the Transformer
family has no audio trunk, so ``--w2v2-model-path`` and ``--fix-*`` raise
for it), the restore
(``--restore-file`` / ``--finetune-from-model`` and the ``--reset-*`` rules of
the JAX CLI), and the loop: ``--update-freq`` micro-batches an update, update
``n`` keyed by ``--seed`` + ``n`` as in JAX, ``--max-update`` /
``--max-epoch`` / ``--stop-time-hours`` / ``--patience``,
``--async-dispatch N`` (up to N updates in flight, their metrics read and
logged at the next log, save, stop or epoch boundary), saves every
``--save-interval`` epochs and ``--save-interval-updates`` updates,
validation (losses over the sample size in bits, BLEU with
``--best-checkpoint-metric bleu``; a joint task's over its main sub-task),
``reduce_lr_on_plateau``'s ``step_val`` after each validation (its state
saved under ``lr_scheduler``, skipped on restore by
``--reset-lr-scheduler``). A joint task's batches come from its
``make_joint_iterator`` behind ``StreamingEpochBatchIterator`` (a resume
restarts the stored epoch, as in JAX). ``--device cuda`` (the default) runs on
the card through the kernels; ``--device cpu`` / ``--cpu`` runs their plain
versions. The train split ships PCM16 audio as int16 and no padding mask
(``manifests.set_wire_format``, rebuilt on the device by
``prepare_batch``) unless ``--no-host-wire``; decoded waveforms are cached
across epochs (``CHIMERA_WAV_CACHE_MB``, ``data/audio.py``). The compute
dtype is ``--dtype`` (bf16 autocast over fp32 parameters, or fp32). ``main`` returns the trainer, the checkpoint manager
and the run's host-clock times. Options that are not ported raise
``NotImplementedError`` naming the ROADMAP item (``options.TRAIN_UNPORTED``).

Several cards (``parallel/``): ``--distributed-world-size N`` on one host
starts N ranks of this program (one a card; gloo ranks under ``--cpu``),
``--distributed-init-method tcp://HOST:PORT --distributed-rank R
--distributed-num-procs N`` makes this process rank R of N (on several
hosts). Every rank builds the same batches and takes its data rank's part;
gradients are all-reduced and normalised by the global sample size. The
grid is data x ``--model-parallel-size`` (tensor parallelism) or data x
``--pipeline-stages`` (the GPipe schedule, ``--pipeline-chunks``
micro-batches, ``--pipeline-checkpoint`` to recompute each stage);
``--zero-sharding os`` splits the optimizer state over the data ranks.
Only rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import logging
import math
import sys
import time
from typing import Dict, Optional

logger = logging.getLogger("chimera_st_tpu_torch.train")


def _rank_main(rank: int, argv) -> None:
    main(argv)


def main(argv=None) -> Optional[dict]:
    from . import options
    from .options import parse_update_freq

    p = options.base_parser("chimera-train (PyTorch port)")
    options.add_train_args(p)
    args, model_overrides = options.parse_with_model_overrides(p, argv)
    options.require_ported(args, options.TRAIN_UNPORTED)
    device = options.resolve_device(args)
    if options.spawn_ranks(args, device, _rank_main, argv):
        return None  # the ranks ran the program
    mesh = options.setup_mesh(args, device)
    from ..parallel.mesh import is_lead

    lead = is_lead()

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout,
    )
    if not lead:
        logging.getLogger("chimera_st_tpu_torch").setLevel(logging.WARNING)

    import numpy as np
    import torch

    from ..checkpoint.store import CheckpointManager, load_params_only, load_state, read_state
    from ..data.audio import wav_cache_stats
    from ..data.iterators import GroupedIterator
    from ..logging import metrics as metrics_mod
    from ..logging.progress_bar import progress_bar
    from ..optim import build_lr_schedule, build_optimizer
    from ..tasks import setup_task
    from ..train.trainer import Trainer

    np.random.seed(args.seed)

    # ----------------------------------------------------------- components
    task_cfg = {"_name": args.task, "data": args.data, "config_yaml": args.config_yaml,
                "source_lang": args.source_lang, "target_lang": args.target_lang,
                **model_overrides}  # unknown flags reach both task and model cfgs
    if args.task_configs:
        # joint training: one config (JSON or YAML file) a sub-task
        task_cfg["task_configs"] = list(args.task_configs)
        if args.main_task:
            task_cfg["main_task"] = args.main_task
    task = setup_task(task_cfg)
    task.load_dataset(args.valid_subset) if not args.disable_validation else None
    task.load_dataset(args.train_subset)

    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" or args.fp16 else torch.float32
    model_cfg = {"arch": args.arch, **model_overrides}
    if args.feature_grad_mult != 1.0:
        model_cfg["feature_grad_mult"] = args.feature_grad_mult
    pipeline = {}
    if args.pipeline_stages > 1:
        # execution config of this run, not the model's identity: never saved
        pipeline = dict(pipeline_stages=args.pipeline_stages,
                        pipeline_chunks=args.pipeline_chunks,
                        pipeline_remat=args.pipeline_checkpoint, pipeline_mesh=mesh)
    model = task.build_model({**model_cfg, **pipeline}, device="cpu", train=True)
    logger.info(f"model arch {args.arch} ({type(model).__name__})")
    from ..convert import model_kind

    interlingua = model_kind(model) == "interlingua"

    lr_schedule = build_lr_schedule(schedule_config(args))
    opt_cfg = optimizer_config(args)
    crit_cfg = {
        "_name": args.criterion,
        "label_smoothing": args.label_smoothing,
        "loss_ratio": tuple(args.loss_ratio),
        "contrastive_temp": args.contrastive_temp,
        "contrastive_increase_until": args.contrastive_increase_until,
        "sentence_avg": args.sentence_avg,
    }
    criterion = task.build_criterion(crit_cfg)

    # ----------------------------------------------------------- init params
    fixes = [f for f in ("fix_wav2vec", "fix_interlingua", "fix_decoder",
                         "fix_decoder_transformers", "fix_encoder_transformers")
             if getattr(args, f, False)]
    if not interlingua and (fixes or model_overrides.get("w2v2_model_path")):
        raise ValueError(f"{args.arch}: --w2v2-model-path and --fix-* apply to the "
                         "interlingua model's audio trunk and memory, which this model has not")
    init_params(model, args, model_overrides)
    if hasattr(task, "post_init_params"):
        # the task's warm start (translation_from_pretrained_xlm: the XLM
        # checkpoint's embeddings and layers)
        task.post_init_params(model, args)
    model.to(device)
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        from ..parallel.partition import apply_tensor_parallel

        split = apply_tensor_parallel(model, mesh)
        logger.info(f"tensor parallel over {mesh.shape['model']} ranks: {len(split)} "
                    "parameters split")
    from ..optim.freeze import auto_text_only_fixes, frozen_fraction, wrap_freeze

    if interlingua and "fix_wav2vec" not in fixes:
        # a text-only task never reaches the audio trunk: masked out of Adam,
        # as the JAX CLI masks it (and, like it, not under --fix-wav2vec)
        fixes.extend(auto_text_only_fixes(task, model))

    trained, frozen = wrap_freeze(model, fixes)
    if fixes:
        logger.info(f"freezing {', '.join(fixes)} "
                    f"({frozen_fraction(model, fixes):.1%} of parameters)")
    from ..convert import checkpoint_axes

    axes = checkpoint_axes(model)
    optimizer = build_optimizer(opt_cfg, trained, clip_norm=args.clip_norm, frozen=frozen,
                                checkpoint_axes=axes)
    if args.zero_sharding == "os" and mesh is not None:
        from ..parallel.partition import ZeroOptimizer

        trained = list(trained)
        optimizer = ZeroOptimizer(optimizer, trained, mesh, lambda shards: build_optimizer(
            opt_cfg, shards, clip_norm=args.clip_norm, frozen=frozen,
            checkpoint_axes={s: axes[p] for s, p in zip(shards, trained)}))
    logger.info(f"device: {device}; params: "
                f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M"
                + (f"; mesh {mesh.shape}" if mesh is not None else ""))

    async_depth = max(args.async_dispatch, 0)
    pad = task.target_dictionary.pad() if task.target_dictionary is not None else None
    trainer = Trainer(model, criterion, optimizer, lr_schedule, compute_dtype,
                      async_depth=async_depth, mesh=mesh, pad=pad)
    # persisted so generate/validate can rebuild the model from the checkpoint
    run_cfg = {"model_cfg": model_cfg, "task_cfg": task_cfg, "criterion_cfg": crit_cfg}

    ckpt_mgr = CheckpointManager(
        args.save_dir,
        maximize_best=args.maximize_best_checkpoint_metric,
        keep_last_epochs=args.keep_last_epochs,
        keep_interval_updates=args.keep_interval_updates,
        keep_best_checkpoints=args.keep_best_checkpoints,
        no_last=args.no_last_checkpoints,
        no_epoch=args.no_epoch_checkpoints,
        no_save=args.no_save or not lead,  # the other ranks track the best only
        save_optimizer_state=not args.no_save_optimizer_state,
    )

    # ----------------------------------------------------------- batch iters
    update_freq = parse_update_freq(args.update_freq)
    if hasattr(task, "make_joint_iterator"):
        # joint training: each sub-task's batches, interleaved by sample
        # ratio and tagged with their task_name, behind the streaming iterator
        from ..data.iterators import StreamingEpochBatchIterator

        if args.num_shards > 1:
            raise SystemExit("--num-shards > 1 is not supported for a joint task: "
                             "its interleaved batches are not sharded")

        class _JointEpochSource:
            epoch = 1

            def set_epoch(self, e):
                self.epoch = e

            def __iter__(self):
                return task.make_joint_iterator(
                    args.train_subset,
                    max_tokens=int(args.max_tokens) if args.max_tokens else None,
                    max_sentences=args.batch_size, seed=args.seed,
                    num_length_buckets=args.num_length_buckets, epoch=self.epoch)

        train_itr = StreamingEpochBatchIterator(_JointEpochSource(),
                                                buffer_size=args.data_buffer_size)
    else:
        train_itr = task.make_batch_iterator(
            task.dataset(args.train_subset),
            max_tokens=int(args.max_tokens) if args.max_tokens else None,
            max_sentences=args.batch_size,
            required_batch_size_multiple=args.required_batch_size_multiple,
            seed=args.seed,
            num_shards=args.num_shards,
            shard_id=args.shard_id,
            num_length_buckets=args.num_length_buckets,
            buffer_size=args.data_buffer_size,
            num_workers=args.num_workers,
        )
        if not args.no_host_wire:
            # the train split's wire format: PCM16 stays int16 up to the card
            # and the padding mask is left out; prepare_batch rebuilds both.
            # Validation and decoding never set it
            from ..data.manifests import set_wire_format

            set_wire_format(task.dataset(args.train_subset))

    # ----------------------------------------------------------- restore
    epoch = 1
    times = {"load_s": 0.0, "save_s": [], "valid_s": [], "valid": []}
    resume_file = ckpt_mgr.save_dir / "checkpoint_last.ckpt"
    if args.finetune_from_model and args.restore_file != "checkpoint_last.ckpt":
        raise SystemExit("--finetune-from-model and --restore-file are mutually exclusive")
    if args.finetune_from_model and resume_file.is_file():
        # a preempted finetune run resumes from its own checkpoint_last
        logger.info(f"{resume_file} exists; resuming it instead of re-applying "
                    f"--finetune-from-model {args.finetune_from_model}")
        args.finetune_from_model = None
    if args.finetune_from_model:
        if (args.reset_optimizer or args.reset_dataloader or args.reset_meters
                or args.reset_lr_scheduler):
            raise SystemExit("--finetune-from-model already resets optimizer/dataloader/"
                             "meters; do not combine it with --reset-* flags")
        load_params_only(args.finetune_from_model, trainer)
        logger.info(f"loaded pretrained params from {args.finetune_from_model} "
                    f"(optimizer/meters/dataloader reset)")
    restore = ckpt_mgr.save_dir / args.restore_file
    if restore.is_file() and not args.finetune_from_model:  # normal resume
        t0 = time.perf_counter()
        fresh = ({k: v.clone() for k, v in model.state_dict().items()}
                 if args.reset_encoder else None)
        payload = read_state(str(restore))
        if args.reset_optimizer:
            # the fresh optimizer state and update count 0 stay
            trainer.load_params(payload["params"])
            extra = payload.get("extra", {})
        else:
            extra = load_state(payload, trainer)
        del payload
        if args.reset_encoder:
            from ..optim.freeze import reset_encoder_subtrees

            logger.info("--reset-encoder: re-initializing the shared encoder "
                        "transformer stack")
            model.load_state_dict(reset_encoder_subtrees(model.state_dict(), fresh))
        trainer.load_extra_state(extra, None if args.reset_dataloader else train_itr,
                                 load_meters=not args.reset_meters,
                                 load_lr_scheduler=not args.reset_lr_scheduler)
        # the best metric is restored only without --reset-optimizer and
        # --reset-meters: an MT -> ST warm start must not import MT's best
        if not args.reset_optimizer and not args.reset_meters:
            ckpt_mgr.best = extra.get("best")
        epoch = extra.get("train_iterator", {}).get("epoch", 1)
        times["load_s"] = time.perf_counter() - t0
        logger.info(f"restored {restore} (epoch {epoch}, {trainer.num_updates} updates)")

    # a state split over ranks is gathered by every rank (collectives); the
    # lead rank writes it
    gathered = mesh is not None and (getattr(model, "tp_split", None)
                                     or args.zero_sharding == "os")

    def save(val, end_of_epoch):
        t0 = time.perf_counter()
        state_fn = trainer.host_state
        if gathered and not args.no_save:
            host = trainer.host_state(not args.no_save_optimizer_state)
            state_fn = lambda _save_opt: host  # noqa: E731
        ckpt_mgr.save(
            state_fn,
            {**trainer.extra_state(train_itr, val, ckpt_mgr.best), **run_cfg},
            epoch, trainer.num_updates, val_metric=val, end_of_epoch=end_of_epoch,
            save_interval_updates=0 if end_of_epoch else args.save_interval_updates,
        )
        times["save_s"].append(time.perf_counter() - t0)

    def validate():
        t0 = time.perf_counter()
        val = validate_and_metric(args, task, trainer)
        times["valid_s"].append(time.perf_counter() - t0)
        times["valid"].append(val)
        return val

    def plateau(val):
        # reduce_lr_on_plateau reads each validation (the step takes the
        # next updates' lr from it)
        if hasattr(lr_schedule, "step_val"):
            lr_schedule.step_val(val)

    times["restored"] = {"step": trainer.num_updates, "epoch": epoch,
                         "train_iterator": train_itr.state_dict()}

    # ----------------------------------------------------------- train loop
    start = time.time()
    # host-clock seconds of each update: fetching its micro-batches and the
    # step, up to the end of its device work (with --async-dispatch, up to
    # its queueing); validation and saves excluded
    times["update_s"] = []
    # host-clock seconds of each epoch's training, up to the end of its
    # device work, and its updates (the end-of-epoch validation and save
    # excluded; those of --save-interval-updates fall inside)
    times["epoch_s"], times["epoch_updates"] = [], []
    # each epoch's data_s (its batches' reads and collation, summed over the
    # collating threads; None for a joint task's stream) and the waveform
    # cache's counts at its end
    times["data_s"], times["wav_cache"] = [], []
    mark = time.perf_counter()
    patience_left = args.patience
    # a non-finite skip keeps num_updates: the interval block must not
    # re-fire on every skipped step at a boundary
    last_interval_validated = -1
    stop = False
    with options.profiled(args):
        while not stop:
            if args.max_epoch and epoch > args.max_epoch:
                break
            train_itr.epoch = epoch
            t_epoch, updates_before = time.perf_counter(), trainer.num_updates
            # --curriculum N: length-ordered (unshuffled) batches for N epochs
            itr = train_itr.next_epoch_itr(shuffle=epoch > args.curriculum)
            grouped = GroupedIterator(itr, update_freq)
            pbar = progress_bar(grouped, log_format=args.log_format,
                                log_interval=args.log_interval, epoch=epoch,
                                tensorboard_logdir=args.tensorboard_logdir if lead else None)
            with metrics_mod.aggregate("train_inner") as agg:
                for microbatches in pbar:
                    trainer.train_step(microbatches, seed=args.seed + trainer.num_updates)
                    if device == "cuda" and not async_depth:
                        torch.cuda.synchronize()
                    times["update_s"].append(time.perf_counter() - mark)
                    # with --async-dispatch the count is the optimistic
                    # mirror: each block that acts on it drains first
                    num_updates = trainer.num_updates
                    if num_updates % args.log_interval == 0:
                        trainer.drain_metrics()
                        num_updates = trainer.num_updates
                        pbar.log(agg.get_smoothed_values(), step=num_updates)
                        metrics_mod.reset_meters("train_inner")
                    if (args.save_interval_updates > 0
                            and num_updates % args.save_interval_updates == 0
                            and num_updates != last_interval_validated):
                        trainer.drain_metrics()
                        num_updates = trainer.num_updates
                        last_interval_validated = num_updates
                        val = None
                        if num_updates >= args.validate_after_updates:
                            val = validate()
                        plateau(val)
                        save(val, end_of_epoch=False)
                    mark = time.perf_counter()
                    if args.max_update and num_updates >= args.max_update:
                        trainer.drain_metrics()
                        if trainer.num_updates >= args.max_update:
                            stop = True
                            break
                    if args.stop_time_hours and \
                            (time.time() - start) / 3600 > args.stop_time_hours:
                        stop = True
                        break
                # the epoch's deferred metrics land in its aggregation
                trainer.drain_metrics()
            if device == "cuda":
                torch.cuda.synchronize()
            times["epoch_s"].append(time.perf_counter() - t_epoch)
            times["epoch_updates"].append(trainer.num_updates - updates_before)
            times["data_s"].append(getattr(train_itr, "data_s", {}).get(epoch))
            times["wav_cache"].append(wav_cache_stats())
            train_itr.next_epoch()

            val = None
            if (not args.disable_validation
                    and trainer.num_updates >= args.validate_after_updates
                    and (epoch % args.validate_interval == 0 or stop)):
                val = validate()
                plateau(val)
                if val is not None and args.patience > 0:
                    if ckpt_mgr.is_better(val):
                        patience_left = args.patience
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            logger.info(f"early stop: patience {args.patience} exhausted")
                            stop = True
            if epoch % args.save_interval == 0 or stop:
                save(val, end_of_epoch=True)
            with metrics_mod.aggregate("train"):
                pass
            epoch += 1
            mark = time.perf_counter()
    if args.profile:
        logger.info(f"profiler trace written to {args.profile}")
    logger.info(f"done training in {time.time() - start:.1f}s "
                f"({trainer.num_updates} updates)")
    if mesh is not None and mesh.shape.get("data", 1) > 1:
        from ..parallel.partition import BATCH_PATHS

        logger.info(f"data ranks: {BATCH_PATHS['train_sliced']} batches split, "
                    f"{BATCH_PATHS['train_whole']} run whole")
    return {"trainer": trainer, "checkpoints": ckpt_mgr, "times": times}


def schedule_config(args) -> Dict:
    """The ``--lr-scheduler`` config, from the flags and with the defaults
    of the JAX train CLI (``chimera_st_tpu/cli/train.py:109-136``)."""
    from .options import parse_lr

    cfg = {
        "_name": args.lr_scheduler,
        "lr": parse_lr(args.lr),
        "warmup_updates": args.warmup_updates,
        "warmup_init_lr": args.warmup_init_lr,
        "max_update": args.max_update,
        "total_num_update": args.total_num_update or args.max_update,
        "end_learning_rate": args.end_learning_rate,
        "power": args.power,
        "lr_shrink": args.lr_shrink,
        "t_mult": args.t_mult,
        "init_lr_scale": args.init_lr_scale,
        "final_lr_scale": args.final_lr_scale,
        "maximize_best_checkpoint_metric": args.maximize_best_checkpoint_metric,
    }
    for key in ("min_lr", "max_lr", "lr_period_updates"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    if args.phase_ratio:
        import ast

        cfg["phase_ratio"] = tuple(ast.literal_eval(args.phase_ratio))
    return cfg


def optimizer_config(args) -> Dict:
    """The ``--optimizer`` config, as the JAX train CLI builds it
    (``chimera_st_tpu/cli/train.py:137-149``)."""
    cfg = {"_name": args.optimizer, "adam_betas": args.adam_betas, "adam_eps": args.adam_eps,
           "weight_decay": args.weight_decay, "adagrad_eps": args.adagrad_eps,
           "adadelta_rho": args.adadelta_rho, "adadelta_eps": args.adadelta_eps,
           "adamax_eps": args.adamax_eps, "lamb_eps": args.lamb_eps}
    if args.momentum:
        cfg["momentum"] = args.momentum
    if args.adamax_betas is not None:
        cfg["adamax_betas"] = args.adamax_betas
    if args.lamb_betas is not None:
        cfg["lamb_betas"] = args.lamb_betas
    return cfg


def init_params(model, args, model_overrides: Dict) -> None:
    """Fresh parameters: the seeded ``init_params_`` (``--seed``), then the
    wav2vec2 trunk of ``--w2v2-model-path`` (a fairseq ``.pt``) through the
    ported importer. The JAX CLI reads that path from ``args``, where the
    undeclared flag never lands, so it keeps its fresh trunk; the port loads
    it."""
    import torch

    from ..models.interlingua import init_params_

    init_params_(model, torch.Generator().manual_seed(int(args.seed)))
    w2v_path = model_overrides.get("w2v2_model_path")
    if w2v_path:
        from ..checkpoint.torch_import import import_wav2vec2_state_dict, load_torch_checkpoint

        sd = import_wav2vec2_state_dict(load_torch_checkpoint(str(w2v_path))["model"])
        model.encoder.wav2vec_model.load_state_dict(sd, strict=True)
        logger.info(f"loaded pretrained wav2vec2 from {w2v_path}")


def validation_batches(args, task, max_tokens=None, max_sentences=None):
    return task.make_batch_iterator(
        task.dataset(args.valid_subset),
        max_tokens=int(max_tokens) if max_tokens else None,
        max_sentences=max_sentences,
        seed=args.seed if getattr(args, "fixed_validation_seed", None) is None
        else args.fixed_validation_seed,
        num_length_buckets=args.num_length_buckets,
    ).next_epoch_itr(shuffle=False)


def validate_and_metric(args, task, trainer) -> Optional[float]:
    """Losses over the valid split (sum / sample size / ln 2), plus BLEU
    with ``--best-checkpoint-metric bleu`` and the greedy CTC WER with
    ``--best-checkpoint-metric wer``; returns the metric named by
    ``--best-checkpoint-metric`` (else ``loss``)."""
    if args.disable_validation:
        return None
    main_task_name = None
    if hasattr(task, "sub_tasks"):
        # joint training validates over its main sub-task
        main_task_name, task = task.main_task_name, task.main_task
    totals: Dict[str, float] = {}
    for batch in validation_batches(args, task, args.max_tokens_valid or args.max_tokens,
                                    args.batch_size_valid or args.batch_size):
        if main_task_name is not None:
            batch = {**batch, "task_name": main_task_name}
        for k, v in trainer.valid_step(batch).items():
            totals[k] = totals.get(k, 0.0) + float(v)
    ss = max(totals.get("sample_size", 1.0), 1.0)
    stats = {k: v / ss / math.log(2) for k, v in totals.items() if k.endswith("loss")}
    if args.best_checkpoint_metric == "bleu":
        stats["bleu"] = validate_bleu(args, task, trainer)
    if args.best_checkpoint_metric == "wer":
        stats["wer"] = validate_wer(args, task, trainer)
    logger.info(
        "validation | " + " | ".join(f"{k} {v:.3f}" for k, v in sorted(stats.items())))
    metric = args.best_checkpoint_metric
    if metric in stats:
        return stats[metric]
    return stats.get("loss")


def validate_bleu(args, task, trainer, beam: int = 4, max_decode_len: int = 64) -> float:
    """Corpus BLEU (sacrebleu, 13a) of beam ``beam`` hypotheses over the
    valid split, as the JAX CLI's: audio batches through
    ``generate_audio``, text batches (``src_tokens``) through
    ``generate_text`` (the interlingua model's text branch, or a
    ``transformer*`` model)."""
    import numpy as np
    import torch

    from ..scoring import build_scorer

    class GenCfg:
        pass

    GenCfg.beam = beam
    GenCfg.max_decode_len = max_decode_len
    GenCfg.lenpen = 1.0
    model = trainer.model
    was_training = model.training
    model.eval()
    try:
        generator = task.build_generator(model, GenCfg)
        tgt_dict = task.target_dictionary
        scorer = build_scorer({"_name": "sacrebleu"}, tgt_dict)
        device = trainer.step.device
        for batch in validation_batches(args, task, args.max_tokens, args.batch_size):
            if "audio" in batch:
                tokens, _, lens = generator.generate_audio(
                    torch.from_numpy(batch["audio"]).to(device),
                    torch.from_numpy(batch["audio_padding_mask"]).to(device))
            else:
                tokens, _, lens = generator.generate_text(
                    torch.from_numpy(batch["src_tokens"]).long().to(device))
            tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
            for b in range(tokens.shape[0]):
                scorer.add_string(
                    tgt_dict.string(np.asarray(batch["target"][b]), bpe_symbol="sentencepiece"),
                    tgt_dict.string(tokens[b, 0, : lens[b, 0]], bpe_symbol="sentencepiece"))
    finally:
        model.train(was_training)
    return scorer.score()


def validate_wer(args, task, trainer) -> float:
    """Corpus WER over the valid split of greedy CTC decodes (JAX
    ``cli/train.py:667-720``): letters joined, ``|`` a word boundary, each
    reference counted as at least one word. A model without a CTC head
    warns and gives inf, as in JAX."""
    import numpy as np
    import torch

    from ..criterions.ctc import ctc_greedy_decode
    from ..scoring.wer import letter_words, levenshtein

    model = trainer.model
    if not hasattr(model, "ctc_logits"):
        logger.warning("--best-checkpoint-metric wer needs a CTC-head model")
        return float("inf")
    d = task.target_dictionary

    device = trainer.step.device
    was_training = model.training
    model.eval()
    errs = total = 0
    try:
        for batch in validation_batches(args, task, args.max_tokens, args.batch_size):
            with torch.inference_mode():
                logits, frame_pad = model.ctc_logits(
                    torch.from_numpy(batch["audio"]).to(device),
                    torch.from_numpy(batch["audio_padding_mask"]).to(device))
            logits = logits.cpu().numpy()
            frame_pad = None if frame_pad is None else frame_pad.cpu().numpy()
            for b in range(logits.shape[0]):
                valid = logits[b] if frame_pad is None else logits[b][~frame_pad[b]]
                hyp = letter_words(d, ctc_greedy_decode(valid, blank_idx=0))
                ref = letter_words(d, np.asarray(batch["target"][b]))
                errs += levenshtein(hyp, ref)
                total += max(len(ref), 1)
    finally:
        model.train(was_training)
    return 100.0 * errs / max(total, 1)


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
