"""Line-driven inference (counterpart of chimera_st_tpu/cli/interactive.py):
for the triplet task, input lines are .wav file paths, from stdin or
``--input``; for a text task (``--task translation``) they are source
sentences, encoded with the source dictionary and padded to a multiple of
16. Output is S-/W-/H-/D-/P- lines.

    python -m chimera_st_tpu_torch.cli.interactive DATA_DIR --task triplet \\
        --path model.pt --beam 10 --lenpen 1.5 --input wavs.txt --buffer-size 8
    python -m chimera_st_tpu_torch.cli.interactive DATA_BIN --task translation \\
        -s en -t de --path checkpoint_best.ckpt --beam 5 < sentences.txt

With ``--constraints {ordered,unordered}`` (text tasks) a line is the source
sentence followed by tab-separated target phrases that every hypothesis
must contain, in the given order or in any order."""

from __future__ import annotations

import functools
import logging
import sys
import time
from types import SimpleNamespace

logger = logging.getLogger("chimera_st_tpu_torch.interactive")


def buffered_read(input_fh, buffer_size: int):
    buf = []
    for line in input_fh:
        line = line.strip()
        if not line:
            continue
        buf.append(line)
        if len(buf) >= buffer_size:
            yield buf
            buf = []
    if buf:
        yield buf


def constraint_strategy(tgt_dict, mode: str, constraints):
    """The search strategy that meets each sentence's constraint phrases
    (``ordered``: in order; ``unordered``: in any order)."""
    from ..generation.search_strategies import (
        LexicallyConstrainedSearch,
        UnorderedLexicallyConstrainedSearch,
        pack_constraint_phrases,
        pack_constraints,
    )

    pad, eos = tgt_dict.pad(), tgt_dict.eos()
    if mode == "unordered":
        return UnorderedLexicallyConstrainedSearch(
            pack_constraint_phrases(constraints, pad=pad), pad=pad, eos=eos)
    return LexicallyConstrainedSearch(pack_constraints(constraints, pad=pad), pad=pad, eos=eos)


def main(argv=None) -> None:
    from . import options
    from .generate import load_model_and_params, require_decoder, to_device, torch_dtype

    p = options.base_parser("chimera-interactive (PyTorch port)")
    options.add_generation_args(p)
    p.add_argument("--buffer-size", type=int, default=1)
    p.add_argument("--input", default="-")
    p.add_argument("--constraints", nargs="?", const="ordered", default=None,
                   choices=["ordered", "unordered"],
                   help="lexically constrained decoding (text tasks): input lines are "
                        "'source\\tphrase1\\tphrase2...'; 'ordered' requires the phrases in "
                        "the given order, 'unordered' in any order")
    args, model_overrides = options.parse_with_model_overrides(p, argv)
    options.require_ported(args)
    options.require_single_host(args, "chimera-interactive")
    device = options.resolve_device(args)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s | %(message)s")

    import numpy as np

    from ..tasks import setup_task

    task_cfg = {"_name": args.task, "data": args.data, "config_yaml": args.config_yaml,
                "source_lang": args.source_lang, "target_lang": args.target_lang}
    task = setup_task(task_cfg)
    tgt_dict = task.target_dictionary

    model = load_model_and_params(args.path, task, torch_dtype(args.dtype), device,
                                  model_overrides)
    require_decoder(model)
    # the JAX CLI forwards these settings here and drops the rest of the
    # generation arguments; a dropped one that is set raises instead
    for flag, default in (("no_repeat_ngram_size", 0), ("min_len_a", 0.0), ("min_len_b", 0),
                          ("prefix_size", 0), ("match_source_len", False),
                          ("unnormalized", False), ("sampling", False), ("sampling_topk", -1),
                          ("sampling_topp", -1.0), ("diverse_beam_groups", -1),
                          ("diversity_rate", -1.0), ("retain_dropout", False),
                          ("score_reference", False), ("print_alignment", False),
                          ("replace_unk", None), ("lm_path", None), ("ctc_lm_path", None),
                          ("iter_decode_max_iter", None), ("iter_decode_force_max_iter", False),
                          ("iter_decode_eos_penalty", 0.0), ("iter_decode_with_beam", 1),
                          ("iter_decode_with_external_reranker", False),
                          ("retain_iter_history", False), ("print_step", False)):
        if getattr(args, flag) != default:
            raise ValueError(f"--{flag.replace('_', '-')} has no effect on interactive "
                             "decoding; use the generate CLI")
    gen_cfg = SimpleNamespace(
        beam=args.beam, max_len_a=args.max_len_a, max_len_b=args.max_len_b,
        min_len=args.min_len, lenpen=args.lenpen, unkpen=args.unkpen,
        temperature=args.temperature, max_decode_len=args.max_decode_len,
        kv_cache_int8=args.kv_cache_int8)
    generator = task.build_generator(model, gen_cfg)
    is_audio_task = hasattr(task, "get_interactive_examples")
    if args.constraints and is_audio_task:
        raise NotImplementedError("--constraints applies to text tasks: lines of an audio task "
                                  "are wav paths, and neither package constrains audio input")
    logger.info("Type a .wav file path per line and press Enter:" if is_audio_task
                else "Type a source sentence per line and press Enter:")

    on_device = functools.partial(to_device, device=device)

    input_fh = sys.stdin if args.input == "-" else open(args.input)
    start_id = 0
    try:
        with options.profiled(args):
            for lines in buffered_read(input_fh, args.buffer_size):
                t0 = time.time()
                if is_audio_task:
                    wavs = task.get_interactive_examples(lines)
                    batch = task.batch_interactive(wavs)
                    tokens, scores, lens = generator.generate_audio(
                        on_device(batch["audio"]),
                        on_device(batch["audio_padding_mask"]),
                        src_lengths=on_device(batch["audio_lengths"]),
                    )
                else:
                    # text task: lines are source sentences
                    from ..data.batching import collate_tokens, round16

                    src_dict = task.source_dictionary
                    gen = generator
                    if args.constraints:
                        # "source\tphrase\tphrase...": the phrases in the target dictionary
                        split = [line.split("\t") for line in lines]
                        lines = [parts[0] for parts in split]
                        constraints = [[[int(t) for t in tgt_dict.encode_line(p, append_eos=False)]
                                        for p in parts[1:]] for parts in split]
                        if any(any(c) for c in constraints):
                            gen = task.build_generator(model, gen_cfg, strategy=constraint_strategy(
                                tgt_dict, args.constraints, constraints))
                    encoded = [src_dict.encode_line(line) for line in lines]
                    src = collate_tokens(encoded, src_dict.pad(),
                                         target_len=round16(max(len(e) for e in encoded)))
                    lengths = np.asarray([len(e) for e in encoded], np.int32)
                    tokens, scores, lens = gen.generate_text(
                        on_device(src).long(), src_lengths=on_device(lengths))
                tokens, scores, lens = (x.cpu().numpy() for x in (tokens, scores.float(), lens))
                for b, line in enumerate(lines):
                    sid = start_id + b
                    print(f"S-{sid}\t{line}")
                    print(f"W-{sid}\t{time.time() - t0:.3f}\tseconds")
                    for k in range(min(args.nbest, tokens.shape[1])):
                        L = int(lens[b, k])
                        hyp = tgt_dict.string(tokens[b, k, :L], bpe_symbol=args.remove_bpe)
                        print(f"H-{sid}\t{scores[b, k]:.4f}\t{hyp}")
                        print(f"D-{sid}\t{scores[b, k]:.4f}\t{hyp}")
                        print(f"P-{sid}\t{scores[b, k]:.4f}")
                start_id += len(lines)
                sys.stdout.flush()
    finally:
        if input_fh is not sys.stdin:
            input_fh.close()


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
