"""chimera-torch-score: score a system output file against a reference file
(counterpart of chimera_st_tpu/cli/score.py; fairseq's ``fairseq-score``).

    python -m chimera_st_tpu_torch.cli.score --sys hyp.txt --ref ref.txt \\
        --scoring sacrebleu | bleu | chrf | wer [--ignore-case]

One hypothesis and one reference a line (``--sys -`` reads the hypotheses
from standard input); prints the scorer's result string. ``bleu`` scores
lines of whitespace-separated integer token ids (the JAX CLI raises for it:
its token-id scorer takes no strings, ROADMAP C).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser("chimera-torch-score")
    p.add_argument("--sys", "-s", required=True)
    p.add_argument("--ref", "-r", required=True)
    p.add_argument("--scoring", default="sacrebleu", choices=["sacrebleu", "bleu", "chrf", "wer"])
    p.add_argument("--ignore-case", action="store_true")
    args = p.parse_args(argv)

    from ..scoring import build_scorer

    scorer = build_scorer({"_name": args.scoring, "sacrebleu_lowercase": args.ignore_case})
    sys_fh = sys.stdin if args.sys == "-" else open(args.sys, encoding="utf-8")
    with open(args.ref, encoding="utf-8") as ref_fh:
        for hyp, ref in zip(sys_fh, ref_fh):
            if args.ignore_case:
                hyp, ref = hyp.lower(), ref.lower()
            if hasattr(scorer, "add_string"):
                scorer.add_string(ref.rstrip("\n"), hyp.rstrip("\n"))
            else:  # the token-id scorer
                scorer.add([int(t) for t in ref.split()], [int(t) for t in hyp.split()])
    print(scorer.result_string())


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
