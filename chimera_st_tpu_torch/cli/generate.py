"""Batched beam-search evaluation (counterpart of
chimera_st_tpu/cli/generate.py: the same output protocol, S-/T-/H-/D-/P-
(and A-) lines and the final corpus score line).

    python -m chimera_st_tpu_torch.cli.generate DATA_DIR --task triplet \\
        --path model.pt --gen-subset tst-COMMON_wave --beam 10 --lenpen 1.5
    python -m chimera_st_tpu_torch.cli.generate DATA_BIN --task translation \\
        --path checkpoint_best.ckpt --gen-subset test --beam 5
    python -m chimera_st_tpu_torch.cli.generate DATA_BIN --task translation_lev \\
        --path levt.ckpt --gen-subset test --iter-decode-max-iter 9 \\
        --iter-decode-eos-penalty 0 --print-step --max-decode-len 64

A batch with audio decodes through ``generate_audio``; a text batch
(``src_tokens``, the translation task) through ``generate_text``, its S-
line the source sentence. ``--path a.pt:b.ckpt`` decodes with the ensemble of
the checkpoints; ``--score-reference`` scores the references instead of
searching (T-/H-/P- lines); ``--print-alignment`` adds an A- line (the last
decoder layer's head-averaged cross-attention argmax per target position,
over a teacher-forced pass of the best hypothesis) and ``--replace-unk``
replaces a text source's unknown words through it. The search options
(``--sampling*``, ``--diverse-beam-*``, ``--diversity-rate``,
``--kv-cache-int8``, ``--retain-dropout``) reach the generator.

``--lm-path LM.ckpt --lm-weight W`` fuses a ``transformer_lm`` into the
decode (shallow fusion, ``generation/ensemble.py``): each step's
distribution is log(mean_i p_i) + W * log_softmax(LM), with one model or
several, speech or text.

Under ``--task audio_pretraining --labels ltr`` a ``wav2vec_ctc`` model
(one with ``ctc_logits`` and no decoder) recognises speech
(``run_ctc_generate``): the per-frame log-probabilities are collapsed
greedily at ``--beam 1`` or searched by prefix beam above it, fused with an
ARPA n-gram LM under ``--ctc-lm-path`` / ``--ctc-lm-weight``; it prints H-
and T- lines and the corpus WER (letters joined, ``|`` a word boundary). A
``wav2vec_seq2seq`` model decodes by beam search as the other speech models.

Under ``--task translation_lev`` / ``translation_ins`` a non-autoregressive
model (CMLM, vanilla / iterative NAT, NAT-CRF, Levenshtein, insertion)
decodes by refinement (``generation/nat_generator.py``, the
``--iter-decode-*`` flags; ``--print-step`` adds an I- line of the step
count, ``--retain-iter-history`` E-{id}_{round} lines of the canvases);
``--path a.ckpt:b.ckpt`` of Levenshtein models is their ensemble
(``generation/nat_ensemble.py``), and with
``--iter-decode-with-external-reranker`` the last ``--path`` is an
autoregressive ``transformer`` that scores the length-beam candidates.

The model runs on ``--device`` (default ``cuda``: the hand-written kernels;
``cpu``: their plain PyTorch versions). ``--path`` takes a fairseq ``.pt`` of
the interlingua model or a native ``.ckpt`` the JAX trainer wrote (the
interlingua model, ``s2t_transformer*``, under ``--task translation`` the
``transformer*`` MT presets, under ``translation_lev`` / ``_ins`` the NAT
models). Options whose feature is not ported yet
raise ``NotImplementedError`` (``options.require_ported``)."""

from __future__ import annotations

import functools
import logging
import sys
import time
from pathlib import Path

logger = logging.getLogger("chimera_st_tpu_torch.generate")


def load_model_and_params(path: str, task, dtype, device="cuda", gen_model_overrides=None):
    """The model of a fairseq torch ``.pt`` or of a native ``.ckpt``, on
    ``device``, in eval mode, its weights loaded (``strict=True``: no tensor
    stays as initialised) and cast to the compute ``dtype``."""
    from ..models.layers import cast_compute_dtype_

    if path.endswith(".pt"):
        from ..checkpoint.torch_import import (
            import_interlingua_state_dict,
            infer_interlingua_config,
            load_torch_checkpoint,
        )
        from ..models.interlingua import ChimeraInterlinguaModel

        ckpt = load_torch_checkpoint(path)
        cfg = infer_interlingua_config(
            ckpt["args"],
            tgt_vocab=len(task.target_dictionary),
            src_vocab=len(task.source_dictionary)
            if task.source_dictionary is not None
            else None,
        )
        model = ChimeraInterlinguaModel(cfg, device=device)
        model.load_state_dict(import_interlingua_state_dict(ckpt["model"]), strict=True)
        return cast_compute_dtype_(model.eval(), dtype)
    # native checkpoint: the train CLI stores model_cfg in extra, so the
    # exact model rebuilds without repeating arch flags
    from ..checkpoint.store import load_native_checkpoint

    tree, model_cfg = load_native_checkpoint(path)
    model_cfg.update(gen_model_overrides or {})
    model_cfg.setdefault("arch", "s2t_transformer_w2v2_interlingua_base")
    return build_and_load(task, model_cfg, tree, dtype, device)


def require_decoder(model) -> None:
    """Raises for a model of the zoo (fconv, lightconv, the LSTMs, berard
    ...), which neither package decodes: none has an incremental decoder
    (chimera_st_tpu/generation/generator.py:190-195 needs
    ``decoder.precompute_encoder_kv``), and the JAX eval_lm / --lm-path
    build ``transformer_lm`` whatever the checkpoint holds (ROADMAP C3)."""
    from .. import convert
    from ..models import ZOO_MODEL_BUILDERS

    kind = convert.model_kind(model)
    if kind in ZOO_MODEL_BUILDERS:
        raise NotImplementedError(f"{kind} has no incremental decoder in either package: it "
                                  "is trained and validated, not decoded (ROADMAP C3)")


def build_and_load(task, model_cfg, tree, dtype, device):
    """``task.build_model(model_cfg)`` with the flax ``tree`` loaded through
    the converter table of its model type (``strict=True``)."""
    from .. import convert

    model = task.build_model(model_cfg, dtype=dtype, device=device)
    model.load_state_dict(convert.params_from_flax(tree, convert.model_kind(model)),
                          strict=True)
    return model


# language models that score a stream (eval_lm) but have no incremental
# step in either package, so no --lm-path fusion (ROADMAP C5)
STEPLESS_LMS = ("hf_gpt2", "transformer_lm_pipe")


def load_language_model(path: str, task, dtype, device="cuda", overrides=None,
                        fusion: bool = False):
    """The language model of a native ``.ckpt`` (``--lm-path`` with
    ``fusion``, ``eval_lm --path``), built on the task's target dictionary,
    with ``overrides`` applied to its stored config: a ``transformer_lm``
    preset, or for ``eval_lm`` GPT-2 or the stacked ``transformer_lm_pipe``.
    The checkpoint's own architecture is kept (``transformer_lm`` only where
    it names none): the JAX CLIs replace it with ``transformer_lm``
    (``chimera_st_tpu/cli/generate.py:362-366``, ``cli/eval_lm.py:56``),
    which rebuilds an LM saved under a preset such as ``transformer_lm_gpt``
    at the base preset's widths and activation (ROADMAP C)."""
    from ..checkpoint.store import load_native_checkpoint
    from ..config.registry import ARCHITECTURES as ALL_ARCHITECTURES
    from ..models import ZOO_ARCHITECTURES
    from ..models.transformer_mt import ARCHITECTURES

    if not path.endswith(".ckpt"):
        raise ValueError(f"{path}: a language model is a native .ckpt")
    tree, model_cfg = load_native_checkpoint(path)
    model_cfg.update(overrides or {})
    arch = model_cfg.setdefault("arch", "transformer_lm")
    if arch in ZOO_ARCHITECTURES:
        raise NotImplementedError(f"{path}: {arch} is a language model of the zoo, which "
                                  "eval_lm and --lm-path do not score in either package "
                                  "(ROADMAP C3)")
    model_name = ALL_ARCHITECTURES.get(arch)[0] if arch in ALL_ARCHITECTURES else None
    if model_name in STEPLESS_LMS:
        if fusion:
            raise NotImplementedError(
                f"{path}: {arch} has no incremental decode step (in either package), so it "
                "cannot be fused by --lm-path; eval_lm scores it (ROADMAP C5)")
        return build_and_load(task, model_cfg, tree, dtype, device)
    if ARCHITECTURES.get(arch, (None,))[0] != "transformer_lm":
        raise ValueError(f"{path}: {arch} is not a transformer_lm architecture")
    return build_and_load(task, model_cfg, tree, dtype, device)


def torch_dtype(name: str):
    import torch

    return torch.bfloat16 if name == "bfloat16" else torch.float32


def to_device(x, device):
    """A host array as a tensor on ``device``."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class GenCfg:
    """The generation settings ``task.build_generator`` reads, from the
    parsed arguments."""

    def __init__(self, args):
        self.beam = args.beam
        self.max_len_a = args.max_len_a
        self.max_len_b = args.max_len_b
        self.min_len = args.min_len
        self.min_len_a = getattr(args, "min_len_a", 0.0)
        self.min_len_b = getattr(args, "min_len_b", 0)
        if getattr(args, "match_source_len", False):
            # pin hypothesis length to source length: max_lens budget REAL
            # tokens, so the source's eos is excluded via b=-1 on both bounds
            self.max_len_a, self.max_len_b = 1.0, -1
            self.min_len_a, self.min_len_b = 1.0, -1
        # --unnormalized: raw log-prob ranking == length divisor len^0
        self.lenpen = 0.0 if getattr(args, "unnormalized", False) else args.lenpen
        self.unkpen = args.unkpen
        self.temperature = args.temperature
        self.max_decode_len = args.max_decode_len
        self.no_repeat_ngram_size = getattr(args, "no_repeat_ngram_size", 0)
        self.diverse_beam_groups = max(args.diverse_beam_groups, 0)
        self.diverse_beam_strength = args.diverse_beam_strength
        self.diversity_rate = args.diversity_rate
        self.sampling = args.sampling
        self.sampling_topk = args.sampling_topk
        self.sampling_topp = args.sampling_topp
        self.seed = args.seed
        self.kv_cache_int8 = args.kv_cache_int8
        self.retain_dropout = args.retain_dropout
        # the non-autoregressive models' refinement (generation/nat_generator.py)
        self.iter_decode_max_iter = args.iter_decode_max_iter
        self.iter_decode_force_max_iter = args.iter_decode_force_max_iter
        self.iter_decode_eos_penalty = args.iter_decode_eos_penalty
        self.iter_decode_with_beam = args.iter_decode_with_beam
        self.iter_decode_with_external_reranker = args.iter_decode_with_external_reranker
        self.retain_iter_history = args.retain_iter_history
        self.print_step = args.print_step


def run_ctc_generate(args, task, model, itr, out, on_device) -> dict:
    """Speech recognition over a CTC head (JAX ``cli/generate.py:65-146``):
    greedy collapse at beam 1, else prefix beam search with the optional
    ARPA LM (``generation/ctc_decoder.py``, on the host). -> the counts,
    the decode's host-clock seconds and the WER."""
    import numpy as np
    import torch

    from ..criterions.ctc import ctc_greedy_decode
    from ..generation.ctc_decoder import ArpaLM, ctc_beam_search
    from ..scoring.wer import letter_words, levenshtein
    from . import options

    tgt_dict = task.target_dictionary
    lm = ArpaLM(args.ctc_lm_path) if args.ctc_lm_path else None
    token_strings = [tgt_dict[i] for i in range(len(tgt_dict))]

    errs = total = n_sent = 0
    t0 = time.time()
    with options.profiled(args):
        for batch in itr:
            with torch.inference_mode():
                logits, frame_pad = model.ctc_logits(on_device(batch["audio"]),
                                                     on_device(batch["audio_padding_mask"]))
                lprobs = torch.log_softmax(logits, dim=-1).cpu().numpy()
            frame_pad = None if frame_pad is None else frame_pad.cpu().numpy()
            for b in range(lprobs.shape[0]):
                sid = int(batch["id"][b]) if "id" in batch else n_sent
                lp = lprobs[b] if frame_pad is None else lprobs[b][~frame_pad[b]]
                if args.beam > 1:
                    hyp_ids, score = ctc_beam_search(
                        lp, beam_size=args.beam, blank=0, lm=lm, lm_weight=args.ctc_lm_weight,
                        token_strings=token_strings)[0]
                else:
                    hyp_ids = ctc_greedy_decode(lp, blank_idx=0)
                    score = float(lp.max(-1).sum())
                hyp = letter_words(tgt_dict, hyp_ids)
                if not args.quiet:
                    print(f"H-{sid}\t{score:.4f}\t{' '.join(hyp)}", file=out)
                if batch.get("target") is not None:
                    ref = letter_words(tgt_dict, np.asarray(batch["target"][b]))
                    if not args.quiet:
                        print(f"T-{sid}\t{' '.join(ref)}", file=out)
                    errs += levenshtein(hyp, ref)
                    total += max(len(ref), 1)
                n_sent += 1
    dt = time.time() - t0
    logger.info(f"Recognized {n_sent} utterances in {dt:.1f}s "
                f"({n_sent / max(dt, 1e-9):.2f} utt/s)")
    wer = 100.0 * errs / total if total else None
    if total:
        print(f"Generate {args.gen_subset} with beam={args.beam}: WER {wer:.2f}", file=out)
    return {"sentences": n_sent, "tokens": 0, "decode_s": dt, "wer": wer}


def run_score_reference(args, task, model, itr, out, on_device, strip) -> int:
    """``--score-reference``: each reference teacher-forced through the
    model; T-, H- (mean log-prob) and P- (each token's log-prob) lines."""
    from ..generation.scorer import SequenceScorer

    tgt_dict = task.target_dictionary
    scorer = SequenceScorer(model, pad=tgt_dict.pad(), eos=tgt_dict.eos(),
                            retain_dropout=args.retain_dropout, seed=args.seed)
    n_sent = 0
    for batch in itr:
        target = on_device(batch["target"]).long()
        if "audio" in batch:
            res = scorer.score_audio(on_device(batch["audio"]),
                                     on_device(batch["audio_padding_mask"]), target)
        else:
            res = scorer.score_text(on_device(batch["src_tokens"]).long(), target)
        score, pos, length = (res[k].cpu().numpy()
                              for k in ("score", "positional_scores", "length"))
        for b in range(target.shape[0]):
            sid = int(batch["id"][b]) if "id" in batch else n_sent
            ref_str = tgt_dict.string(batch["target"][b], bpe_symbol=args.remove_bpe,
                                      extra_symbols_to_ignore=strip)
            if not args.quiet:
                print(f"T-{sid}\t{ref_str}", file=out)
                print(f"H-{sid}\t{score[b]:.4f}\t{ref_str}", file=out)
                print(f"P-{sid}\t" + " ".join(f"{p:.4f}" for p in pos[b][:int(length[b])]),
                      file=out)
            n_sent += 1
    logger.info(f"Scored {n_sent} reference sentences")
    return n_sent


def best_alignments(model, batch, tokens, eos: int, on_device):
    """[B, max_decode_len] source positions: the argmax of the last decoder
    layer's head-averaged cross-attention over a teacher-forced pass of each
    sentence's best hypothesis."""
    import numpy as np
    import torch

    with torch.inference_mode():
        if "audio" in batch:
            enc, enc_mask = model.encode_audio(on_device(batch["audio"]),
                                               on_device(batch["audio_padding_mask"]))
        else:
            enc, enc_mask = model.encode_text(on_device(batch["src_tokens"]).long())
        prev = np.concatenate([np.full((tokens.shape[0], 1), eos, np.int64),
                               tokens[:, 0, :-1].astype(np.int64)], axis=1)
        attn = model.decoder.cross_attention_weights(on_device(prev), enc, enc_mask)
    return attn.argmax(dim=-1).cpu().numpy()


def unk_replaced(task, src_tokens, hyp_ids, alignment, align_dict, remove_bpe, strip) -> str:
    """The hypothesis string with each <unk> replaced by its aligned source
    word (before BPE is removed, as the alignment indexes raw source
    tokens)."""
    from ..data.dictionary import post_process
    from ..generation.unk_replace import replace_unk_tokens

    tgt_dict = task.target_dictionary
    src_dict = getattr(task, "source_dictionary", None) or tgt_dict
    src_words = [src_dict[int(t)] for t in src_tokens
                 if int(t) not in (src_dict.pad(), src_dict.eos())]
    syms = replace_unk_tokens([tgt_dict[int(t)] for t in hyp_ids], src_words, alignment,
                              align_dict, tgt_dict[tgt_dict.unk()])
    kept = [sym for t, sym in zip(hyp_ids, syms)
            if int(t) not in strip and int(t) not in (tgt_dict.pad(), tgt_dict.eos())]
    return post_process(" ".join(kept), remove_bpe)


def print_refinement(args, generator, b: int, sid: int, tgt_dict, strip, out) -> None:
    """A NAT hypothesis's refinement lines, as the JAX CLI prints them:
    ``I-{id}`` its step count under ``--print-step``, ``E-{id}_{round}`` the
    canvas of each round up to one past its last step under
    ``--retain-iter-history``."""
    steps = getattr(generator, "last_steps", None)
    if args.print_step and steps is not None:
        print(f"I-{sid}\t{int(steps[b])}", file=out)
    hist = getattr(generator, "last_history", None)
    if args.retain_iter_history and hist is not None:
        rounds = hist.shape[0]
        upto = rounds if steps is None else min(int(steps[b]) + 1, rounds)
        for j in range(upto):
            ids = [int(t) for t in hist[j, b] if int(t) != tgt_dict.pad()]
            text = tgt_dict.string(ids, bpe_symbol=args.remove_bpe, extra_symbols_to_ignore=strip)
            print(f"E-{sid}_{j}\t{text}", file=out)


def main(argv=None) -> dict:
    """Runs the evaluation and returns its counts and host-clock times
    (``sentences``, ``tokens``, ``load_s``, ``decode_s``)."""
    from . import options

    p = options.base_parser("chimera-generate (PyTorch port)")
    options.add_generation_args(p)
    args, model_overrides = options.parse_with_model_overrides(p, argv)
    options.require_ported(args)
    device = options.resolve_device(args)
    if options.spawn_ranks(args, device, _rank_main, argv):
        return None  # the ranks decoded
    mesh = options.setup_data_mesh(args, device)
    from ..parallel.mesh import is_lead

    lead = is_lead()
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s | %(message)s")
    if not lead:
        logging.getLogger("chimera_st_tpu_torch").setLevel(logging.WARNING)

    import numpy as np

    from ..scoring import build_scorer
    from ..tasks import setup_task

    task_cfg = {"_name": args.task, "data": args.data, "config_yaml": args.config_yaml,
                "source_lang": args.source_lang, "target_lang": args.target_lang,
                **model_overrides}  # unknown flags reach the task
    task = setup_task(task_cfg)
    task.load_dataset(args.gen_subset)
    dataset = task.dataset(args.gen_subset)
    tgt_dict = task.target_dictionary

    t_load = time.time()
    paths = args.path.split(":")
    reranker = None
    if args.iter_decode_with_external_reranker:
        # the last --path is the autoregressive reranker, the rest decode
        if len(paths) < 2:
            raise ValueError("--iter-decode-with-external-reranker: give at least two --path "
                             "checkpoints; the last one is the AR reranker")
        reranker = load_model_and_params(paths[-1], task, torch_dtype(args.dtype), device,
                                         model_overrides)
        paths = paths[:-1]
        if len(paths) > 1:
            raise NotImplementedError("external reranking over a NAT *ensemble* is not "
                                      "supported; use one decoding checkpoint + one reranker")
    models = [load_model_and_params(path, task, torch_dtype(args.dtype), device,
                                    model_overrides) for path in paths]
    for m in models + ([reranker] if reranker is not None else []):
        require_decoder(m)
    model = models[0]
    load_s = time.time() - t_load
    from ..generation.nat_generator import is_nat

    if is_nat(model) and (args.score_reference or args.print_alignment or args.replace_unk):
        raise NotImplementedError("--score-reference / --print-alignment / --replace-unk need "
                                  "an autoregressive decoder; the NAT models decode by refinement")
    logger.info(f"loaded {args.path} on {device} in {load_s:.1f}s")

    itr = task.make_batch_iterator(
        dataset,
        max_tokens=int(args.max_tokens) if args.max_tokens else None,
        max_sentences=args.batch_size,
        num_length_buckets=args.num_length_buckets,
    ).next_epoch_itr(shuffle=False)

    out = open(Path(args.results_path) / f"generate-{args.gen_subset}.txt", "w") \
        if args.results_path and lead else sys.stdout
    strip = task.lang_tag_indices() if hasattr(task, "lang_tag_indices") else set()
    on_device = functools.partial(to_device, device=device)

    if hasattr(model, "ctc_logits") and not hasattr(model, "decoder"):
        # speech recognition over a CTC head (wav2vec_ctc)
        stats = run_ctc_generate(args, task, model, itr, out, on_device)
        if out is not sys.stdout:
            out.close()
        return {**stats, "load_s": load_s}

    if args.score_reference:
        t0 = time.time()
        n_sent = run_score_reference(args, task, model, itr, out, on_device, strip)
        if out is not sys.stdout:
            out.close()
        return {"sentences": n_sent, "tokens": 0, "load_s": load_s,
                "decode_s": time.time() - t0}

    gen_cfg = GenCfg(args)
    from ..generation.nat_ensemble import build_nat_ensemble_generator

    nat_ensemble = None
    if len(models) > 1 or args.lm_path:
        nat_ensemble = build_nat_ensemble_generator(models, gen_cfg, tgt_dict)
    if nat_ensemble is not None:
        # the Levenshtein ensemble's refinement (EnsembleLevT)
        if args.lm_path:
            raise NotImplementedError("--lm-path is not supported for NAT decoding")
        generator = nat_ensemble
    elif len(models) > 1 or args.lm_path:
        # plain beam search; the single-model options raise there
        from ..generation.ensemble import EnsembleSequenceGenerator
        from ..generation.generator import refuse_nat_settings, settings_from_cfg

        refuse_nat_settings(gen_cfg)
        lm = None
        if args.lm_path:
            lm = (load_language_model(args.lm_path, task, torch_dtype(args.dtype), device,
                                      fusion=True), args.lm_weight)
        generator = EnsembleSequenceGenerator(models, settings_from_cfg(gen_cfg),
                                              pad=tgt_dict.pad(), eos=tgt_dict.eos(),
                                              unk=tgt_dict.unk(), lm=lm)
    elif reranker is not None:
        generator = task.build_generator(model, gen_cfg, reranker=reranker)
    else:
        generator = task.build_generator(model, gen_cfg)

    scorer = build_scorer({"_name": args.scoring}, tgt_dict)
    align_dict = None
    if args.replace_unk:
        from ..generation.unk_replace import load_align_dict

        align_dict = load_align_dict(args.replace_unk)

    prefix_size = int(getattr(args, "prefix_size", 0) or 0)
    if prefix_size > 0 and not getattr(generator, "supports_prefix", False):
        raise NotImplementedError("--prefix-size is only supported for the single-model "
                                  "beam decode")

    n_sent = 0
    n_tokens = 0
    t0 = time.time()
    from ..parallel.partition import count_batch_path, gather_rows, split_batch

    with options.profiled(args):
        for batch in itr:
            ids = batch["id"]
            # several ranks: each decodes its slice of the batch (or, where
            # the batch does not divide, the whole batch) and the lead rank
            # prints every sentence in the input order
            part, sliced = split_batch(batch, mesh)
            if mesh is not None and mesh.shape.get("data", 1) > 1:
                count_batch_path("decode", sliced)
            extra = {}
            if prefix_size > 0 and part.get("target") is not None:
                # force each hypothesis to start with the reference's first
                # prefix_size tokens; pad rows force nothing
                extra["prefix_tokens"] = on_device(
                    np.asarray(part["target"])[:, :prefix_size].astype(np.int64))
            if "audio" in part:
                tokens, scores, lens = generator.generate_audio(
                    on_device(part["audio"]),
                    on_device(part["audio_padding_mask"]),
                    src_lengths=on_device(part["audio_lengths"]),
                    **extra,
                )
            else:
                tokens, scores, lens = generator.generate_text(
                    on_device(part["src_tokens"]).long(),
                    src_lengths=on_device(part["src_lengths"]),
                    **extra,
                )
            tokens, scores, lens = (x.cpu().numpy() for x in (tokens, scores.float(), lens))
            if sliced:
                tokens, scores, lens = gather_rows(mesh, tokens, scores, lens,
                                                   pad_value=tgt_dict.pad())
            if not lead:
                continue
            alignments = None
            if args.print_alignment or (args.replace_unk and "src_tokens" in batch):
                alignments = best_alignments(model, batch, tokens, tgt_dict.eos(), on_device)
            for b in range(tokens.shape[0]):
                sid = int(ids[b])
                target = batch.get("target")
                ref_str = None
                if target is not None:
                    ref_str = tgt_dict.string(
                        target[b], bpe_symbol=args.remove_bpe, extra_symbols_to_ignore=strip)
                if not args.quiet:
                    # S- carries the detokenized source when a text source
                    # exists; audio inputs print an empty source
                    src_str = ""
                    src_dict = getattr(task, "source_dictionary", None)
                    if "src_tokens" in batch and src_dict is not None:
                        src_str = src_dict.string(
                            batch["src_tokens"][b], bpe_symbol=args.remove_bpe,
                            extra_symbols_to_ignore=strip)
                    print(f"S-{sid}\t{src_str}", file=out)
                    if ref_str is not None:
                        print(f"T-{sid}\t{ref_str}", file=out)
                for k in range(min(args.nbest, tokens.shape[1])):
                    L = int(lens[b, k])
                    hyp_ids = tokens[b, k, :L]
                    if args.replace_unk and alignments is not None and "src_tokens" in batch \
                            and k == 0:
                        hyp_str = unk_replaced(task, batch["src_tokens"][b], hyp_ids,
                                               alignments[b][:L], align_dict, args.remove_bpe,
                                               strip)
                    else:
                        hyp_str = tgt_dict.string(
                            hyp_ids, bpe_symbol=args.remove_bpe, extra_symbols_to_ignore=strip)
                    if not args.quiet:
                        print(f"H-{sid}\t{scores[b, k]:.4f}\t{hyp_str}", file=out)
                        print(f"D-{sid}\t{scores[b, k]:.4f}\t{hyp_str}", file=out)
                        print(f"P-{sid}\t{scores[b, k]:.4f}", file=out)
                        if k == 0:
                            print_refinement(args, generator, b, sid, tgt_dict, strip, out)
                        if alignments is not None and k == 0 and args.print_alignment:
                            pairs = " ".join(f"{int(alignments[b, t])}-{t}" for t in range(L))
                            print(f"A-{sid}\t{pairs}", file=out)
                    if k == 0 and ref_str is not None:
                        if hasattr(scorer, "add_string"):
                            scorer.add_string(ref_str, hyp_str)
                        else:
                            scorer.add([int(t) for t in target[b]], [int(t) for t in hyp_ids])
                        n_tokens += L
                n_sent += 1
    dt = time.time() - t0
    logger.info(
        f"Translated {n_sent} sentences ({n_tokens} tokens) in {dt:.1f}s "
        f"({n_sent / max(dt, 1e-9):.2f} sentences/s, {n_tokens / max(dt, 1e-9):.2f} tokens/s)"
    )
    if n_sent and hasattr(scorer, "result_string"):
        print(f"Generate {args.gen_subset} with beam={args.beam}: {scorer.result_string()}",
              file=out)
    if out is not sys.stdout:
        out.close()
    return {"sentences": n_sent, "tokens": n_tokens, "load_s": load_s, "decode_s": dt}


def _rank_main(rank: int, argv) -> None:
    main(argv)


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
