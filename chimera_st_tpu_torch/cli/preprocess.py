"""Text binarization (counterpart of chimera_st_tpu/cli/preprocess.py, the
JAX package's ``chimera-preprocess``): builds the dictionaries and writes
fairseq-format mmap-indexed datasets, byte for byte what the JAX package
writes (int32 tokens, eos appended, no bos).

    python -m chimera_st_tpu_torch.cli.preprocess -s en -t de \\
        --trainpref wmt/train --validpref wmt/valid --testpref wmt/test \\
        --destdir data-bin --joined-dictionary

Host-only (numpy). ``--workers`` is accepted and, as in the JAX package,
binarizes in one process."""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

logger = logging.getLogger("chimera_st_tpu_torch.preprocess")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("chimera-preprocess (PyTorch port)")
    p.add_argument("--source-lang", "-s", default=None)
    p.add_argument("--target-lang", "-t", default=None)
    p.add_argument("--only-source", action="store_true",
                   help="binarize the source side only: dict.txt + {split}.bin/idx, no "
                        "language pair in the file names (the LM layout)")
    p.add_argument("--trainpref", default=None)
    p.add_argument("--validpref", default=None)
    p.add_argument("--testpref", default=None)
    p.add_argument("--destdir", required=True)
    p.add_argument("--srcdict", default=None)
    p.add_argument("--tgtdict", default=None)
    p.add_argument("--joined-dictionary", action="store_true")
    p.add_argument("--nwordssrc", type=int, default=-1)
    p.add_argument("--nwordstgt", type=int, default=-1)
    p.add_argument("--thresholdsrc", type=int, default=0)
    p.add_argument("--thresholdtgt", type=int, default=0)
    p.add_argument("--workers", type=int, default=1)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s | %(message)s")

    from ..data.dictionary import Dictionary
    from ..data.indexed_dataset import MMapIndexedDatasetBuilder

    dest = Path(args.destdir)
    dest.mkdir(parents=True, exist_ok=True)
    src, tgt = args.source_lang, args.target_lang
    if not args.only_source and (src is None or tgt is None):
        p.error("--source-lang/--target-lang are required unless --only-source")

    def build_dict(pref_files, threshold, nwords):
        d = Dictionary()
        for path in pref_files:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    for w in line.split():
                        d.add_symbol(w)
        d.finalize(threshold=threshold, nwords=nwords)
        return d

    def train_path(lang):
        return f"{args.trainpref}.{lang}" if lang else args.trainpref

    def require_trainpref(what):
        if not args.trainpref:
            p.error(f"--trainpref required to build the {what} dictionary")

    if args.srcdict:
        src_dict = Dictionary.load(args.srcdict)
    elif args.joined_dictionary:
        require_trainpref("joined")
        # each training file once: with --only-source both languages name
        # the same file, and counting it twice would skew the threshold
        src_dict = build_dict(list(dict.fromkeys(train_path(lang) for lang in (src, tgt))),
                              args.thresholdsrc, args.nwordssrc)
    else:
        require_trainpref("source")
        src_dict = build_dict([train_path(src)], args.thresholdsrc, args.nwordssrc)
    if args.only_source:
        tgt_dict = src_dict
    elif args.tgtdict:
        tgt_dict = Dictionary.load(args.tgtdict)
    elif args.joined_dictionary:
        tgt_dict = src_dict
    else:
        # --srcdict alone does not join: the target dictionary comes from
        # the training data
        require_trainpref("target")
        tgt_dict = build_dict([train_path(tgt)], args.thresholdtgt, args.nwordstgt)

    src_dict.save(str(dest / (f"dict.{src}.txt" if src else "dict.txt")))
    if not args.only_source:
        tgt_dict.save(str(dest / f"dict.{tgt}.txt"))

    def dest_prefix(split: str, lang: str) -> str:
        if args.only_source:
            return str(dest / split)
        return str(dest / f"{split}.{src}-{tgt}.{lang}")

    def binarize(pref: str, split: str, lang: str, d: Dictionary):
        builder = MMapIndexedDatasetBuilder(dest_prefix(split, lang))
        n_tok, n_unk = 0, 0
        in_path = f"{pref}.{lang}" if lang else pref
        with open(in_path, encoding="utf-8") as f:
            for line in f:
                ids = d.encode_line(line, append_eos=True)
                n_tok += len(ids)
                n_unk += int((ids == d.unk()).sum())
                builder.add_item(ids)
        builder.finalize()
        logger.info(f"[{lang or 'source'}] {split}: {n_tok} tokens, "
                    f"{100.0 * n_unk / max(n_tok, 1):.3f}% replaced by <unk>")

    for pref, split in ((args.trainpref, "train"), (args.validpref, "valid"),
                        (args.testpref, "test")):
        if pref:
            binarize(pref, split, src, src_dict)
            if not args.only_source:
                binarize(pref, split, tgt, tgt_dict)
    logger.info(f"Wrote binarized data to {dest}")


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
