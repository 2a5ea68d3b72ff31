"""chimera-torch-prepare-wmt: the WMT / OPUS-100 MT pre-training data
pipeline (own copy of chimera_st_tpu/tools/prepare_wmt.py; Chimera's
``prepare-wmt-en2any.sh``, ``prepare-opus100-en2any.sh`` and
``append-mustc-to-wmt.sh``): moses punctuation normalization and
non-printing removal in Python, tokenization with ``sacremoses`` (imported in
``main``), clean-corpus-n's length and ratio filter, a joint BPE learned by
frequency merges and applied with the port's ``SubwordNMTBPE``; then
``chimera-torch-preprocess`` binarizes. It runs on the host's CPU and never
touches a device.

The corpora are not downloaded (``recipes/download-wmt.sh`` /
``download-opus100.sh`` name their URLs). Inputs are plain parallel text
files under ``--data-dir/orig``:

    orig/<corpus>.<pair>.<lang>   e.g. orig/europarl-v7.de-en.de

Usage:
    chimera-torch-prepare-wmt --data-dir DATA --target de \
        --corpora europarl-v7.de-en commoncrawl.de-en \
        --valid-frac 0.002 --subword-tokens 40000 [--append-mustc MUSTC_DIR]
    # -> DATA/wmt_en_de/{train,valid,test}.{en,de} + codes file
    # then: chimera-torch-preprocess -s en -t de --trainpref ... --joined-dictionary
"""

from __future__ import annotations

import argparse
import logging
import re
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Tuple

logger = logging.getLogger("chimera_st_tpu_torch.prepare_wmt")

# moses normalize-punctuation.perl, the subset that affects WMT text
# (unicode quotes / dashes / spaces -> ascii), then remove-non-printing-char
_PUNCT_RULES = [
    (re.compile(r"\r"), ""),
    (re.compile(r"­"), ""),  # soft hyphen
    (re.compile(r"[‘’‚`´]"), "'"),
    (re.compile(r"[“”„«»]"), '"'),
    (re.compile(r"[–—]"), " - "),
    (re.compile(r"…"), "..."),
    (re.compile(r"[   ]"), " "),
    (re.compile(r" +"), " "),
]


def normalize_punctuation(line: str) -> str:
    for rx, rep in _PUNCT_RULES:
        line = rx.sub(rep, line)
    return line.strip()


def remove_non_printing(line: str) -> str:
    return "".join(
        c if not unicodedata.category(c).startswith("C") else " " for c in line
    )


def clean_pair(src: str, tgt: str, min_len=1, max_len=250, ratio=1.5) -> bool:
    """clean-corpus-n.perl semantics: token-count bounds + length ratio."""
    ls, lt = len(src.split()), len(tgt.split())
    if not (min_len <= ls <= max_len and min_len <= lt <= max_len):
        return False
    if ls / max(lt, 1) > ratio or lt / max(ls, 1) > ratio:
        return False
    return True


def learn_bpe(lines: Iterable[str], num_merges: int) -> List[Tuple[str, str]]:
    """subword-nmt-style BPE merge learning: merge the most frequent
    adjacent symbol pair over the word-frequency table, ``num_merges``
    times or until no pair occurs twice."""
    vocab: Counter = Counter()
    for line in lines:
        for w in line.split():
            vocab[tuple(w[:-1]) + (w[-1] + "</w>",)] += 1
    merges: List[Tuple[str, str]] = []
    words = dict(vocab)
    for _ in range(num_merges):
        pair_counts: Counter = Counter()
        for word, freq in words.items():
            for a, b in zip(word, word[1:]):
                pair_counts[(a, b)] += freq
        if not pair_counts:
            break
        best, freq = pair_counts.most_common(1)[0]
        if freq < 2:
            break
        merges.append(best)
        a, b = best
        merged = a + b
        new_words = {}
        for word, f in words.items():
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + f
        words = new_words
    return merges


def _read_norm(path: Path) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [normalize_punctuation(remove_non_printing(l)) for l in f]


def main(argv=None) -> None:
    p = argparse.ArgumentParser("chimera-torch-prepare-wmt")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--source", default="en")
    p.add_argument("--target", required=True)
    p.add_argument("--corpora", nargs="+", required=True,
                   help="corpus stems under orig/ (e.g. europarl-v7.de-en)")
    p.add_argument("--test-corpus", default=None,
                   help="corpus stem for the test split (else split from train)")
    p.add_argument("--valid-frac", type=float, default=0.002,
                   help="fraction of train held out as valid (the recipe's "
                        "--devset split-train mode)")
    p.add_argument("--subword-tokens", type=int, default=40000)
    p.add_argument("--append-mustc", default=None,
                   help="MuST-C en-<tgt> dir whose train text is appended "
                        "(append-mustc-to-wmt.sh)")
    p.add_argument("--out-name", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from sacremoses import MosesTokenizer

    root = Path(args.data_dir)
    src, tgt = args.source, args.target
    out = root / (args.out_name or f"wmt_{src}_{tgt}")
    out.mkdir(parents=True, exist_ok=True)
    tok = {l: MosesTokenizer(lang=l) for l in (src, tgt)}

    def tokenize(lang: str, lines: List[str]) -> List[str]:
        return [
            " ".join(tok[lang].tokenize(l, aggressive_dash_splits=True))
            for l in lines
        ]

    pairs: List[Tuple[str, str]] = []
    for stem in args.corpora:
        s_lines = tokenize(src, _read_norm(root / "orig" / f"{stem}.{src}"))
        t_lines = tokenize(tgt, _read_norm(root / "orig" / f"{stem}.{tgt}"))
        if len(s_lines) != len(t_lines):
            raise SystemExit(f"{stem}: {len(s_lines)} {src} lines, {len(t_lines)} {tgt} lines")
        kept = [(a, b) for a, b in zip(s_lines, t_lines) if clean_pair(a, b)]
        logger.info(f"{stem}: {len(kept)}/{len(s_lines)} pairs kept")
        pairs.extend(kept)

    if args.append_mustc:
        mdir = Path(args.append_mustc) / "data" / "train" / "txt"
        s_lines = tokenize(src, _read_norm(mdir / f"train.{src}"))
        t_lines = tokenize(tgt, _read_norm(mdir / f"train.{tgt}"))
        kept = [(a, b) for a, b in zip(s_lines, t_lines) if clean_pair(a, b)]
        logger.info(f"must-c appended: {len(kept)} pairs")
        pairs.extend(kept)

    n_valid = max(int(len(pairs) * args.valid_frac), 1)
    valid, train = pairs[:n_valid], pairs[n_valid:]
    if args.test_corpus:
        s_lines = tokenize(src, _read_norm(root / "orig" / f"{args.test_corpus}.{src}"))
        t_lines = tokenize(tgt, _read_norm(root / "orig" / f"{args.test_corpus}.{tgt}"))
        test = list(zip(s_lines, t_lines))
    else:
        test, valid = valid[: max(n_valid // 2, 1)], valid[max(n_valid // 2, 1):] or valid

    logger.info(f"learning joint BPE ({args.subword_tokens} merges) ...")
    merges = learn_bpe((a + " " + b for a, b in train), args.subword_tokens)
    codes = out / f"codes.{src}-{tgt}"
    with open(codes, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")

    from ..data.encoders_bpe import SubwordNMTBPE

    bpe = SubwordNMTBPE({"bpe_codes": str(codes)})
    for split, rows in (("train", train), ("valid", valid), ("test", test)):
        with open(out / f"{split}.{src}", "w", encoding="utf-8") as fs, open(
            out / f"{split}.{tgt}", "w", encoding="utf-8"
        ) as ft:
            for a, b in rows:
                fs.write(bpe.encode(a) + "\n")
                ft.write(bpe.encode(b) + "\n")
    logger.info(
        f"wrote {out}: train {len(train)}, valid {len(valid)}, test {len(test)}; "
        f"next: chimera-torch-preprocess -s {src} -t {tgt} --joined-dictionary "
        f"--trainpref {out}/train --validpref {out}/valid --testpref {out}/test"
    )


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
