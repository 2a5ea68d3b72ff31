"""chimera-torch-apply-spm: encode a text file with a sentencepiece model
(own copy of chimera_st_tpu/tools/apply_spm.py; Chimera's
``prepare_data/apply_spm.py``, the same flags): each line's pieces joined by
spaces, read by the port's own SPM reader (``data/spm.py``), with no
``sentencepiece`` wheel. It runs on the host's CPU."""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser("chimera-torch-apply-spm")
    p.add_argument("--input-file", required=True)
    p.add_argument("--output-file", required=True)
    p.add_argument("--model", required=True)
    args = p.parse_args(argv)

    from ..data.spm import SentencePieceUnigram

    sp = SentencePieceUnigram.load(args.model)
    with open(args.input_file, encoding="utf-8") as fin, open(
        args.output_file, "w", encoding="utf-8"
    ) as fout:
        for line in fin:
            fout.write(" ".join(sp.encode_pieces(line.strip())) + "\n")


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
