"""The port's data-preparation front end against the JAX package on the CPU:
``tools/prepare_wmt.py`` (normalize, tokenize with ``sacremoses``, clean,
learn and apply a joint BPE), ``tools/apply_spm.py``, and the recipes
``recipes/prepare-wmt-en2any.sh`` / ``prepare-opus100-en2any.sh`` run
unchanged through console-script shims that point ``chimera-prepare-wmt``
and ``chimera-preprocess`` at the port. Every comparison is byte for byte.
The corpus is the one of ``tests/test_prepare_wmt.py``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from chimera_st_tpu.cli import preprocess as jax_preprocess
from chimera_st_tpu.tools import apply_spm as jax_apply_spm
from chimera_st_tpu.tools import prepare_wmt as jax_prepare_wmt
from chimera_st_tpu_torch.tools import apply_spm, prepare_wmt
from tests.test_prepare_wmt import SRC_SENTS, TGT_SENTS
from tests.test_torch_data import PIECES, SENTENCES, write_spm_model

pytest.importorskip("sacremoses", reason="prepare_wmt tokenizes with sacremoses")

REPO = Path(__file__).resolve().parents[1]
SHIMS = {
    "chimera-prepare-wmt": "chimera_st_tpu_torch.tools.prepare_wmt",
    "chimera-preprocess": "chimera_st_tpu_torch.cli.preprocess",
}


def _corpus(orig: Path, stem: str, src="en", tgt="de", n_rep: int = 8, shift: int = 0):
    """``n_rep`` copies of the six pairs (rotated by ``shift``) and one pair
    that the ratio filter drops, as ``orig/{stem}.{lang}``."""
    orig.mkdir(parents=True, exist_ok=True)
    pairs = list(zip(SRC_SENTS, TGT_SENTS))
    pairs = (pairs[shift:] + pairs[:shift]) * n_rep + [("a", " ".join(["wort"] * 40))]
    (orig / f"{stem}.{src}").parent.mkdir(parents=True, exist_ok=True)
    (orig / f"{stem}.{src}").write_text("".join(a + "\n" for a, _ in pairs), encoding="utf-8")
    (orig / f"{stem}.{tgt}").write_text("".join(b + "\n" for _, b in pairs), encoding="utf-8")


def _files(d: Path):
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


PREPARE = {
    "wmt": ["--corpora", "mini.de-en", "--subword-tokens", "60", "--valid-frac", "0.2"],
    "opus_test_corpus": ["--corpora", "mini.de-en", "--test-corpus", "mini-test.de-en",
                         "--out-name", "opus_en_de", "--subword-tokens", "40000"],
}


@pytest.mark.parametrize("case", PREPARE)
def test_prepare_wmt_writes_the_jax_files(tmp_path, case):
    """The same corpus prepared by both packages: every output file (the
    BPE codes and each split of each side) byte-equal."""
    outs = []
    for name, mod in (("port", prepare_wmt), ("jax", jax_prepare_wmt)):
        root = tmp_path / name
        _corpus(root / "orig", "mini.de-en")
        _corpus(root / "orig", "mini-test.de-en", n_rep=1, shift=2)
        mod.main(["--data-dir", str(root), "--target", "de", *PREPARE[case]])
        outs.append(_files(root / ("opus_en_de" if "opus" in case else "wmt_en_de")))
    got, want = outs
    assert sorted(got) == sorted(want) and len(got) == 7
    for k in want:
        assert got[k] == want[k], k
    # 60 merges leave words split; 40,000 run until no pair occurs twice
    assert (b"@@" in got["train.en"]) is (case == "wmt")


def test_apply_spm_writes_the_jax_file(tmp_path):
    model = tmp_path / "spm.model"
    write_spm_model(model, PIECES)
    src = tmp_path / "in.txt"
    src.write_text("".join(s + "\n" for s in SENTENCES), encoding="utf-8")
    for name, mod in (("port", apply_spm), ("jax", jax_apply_spm)):
        mod.main(["--input-file", str(src), "--output-file", str(tmp_path / f"{name}.txt"),
                  "--model", str(model)])
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes() and got.count(b"\n") == len(SENTENCES)
    assert "▁".encode() in got


@pytest.fixture(scope="module")
def shim_bin(tmp_path_factory):
    bin_dir = tmp_path_factory.mktemp("bin")
    for name, mod in SHIMS.items():
        sh = bin_dir / name
        sh.write_text(f'#!/usr/bin/env bash\nexec {sys.executable} -m {mod} "$@"\n')
        sh.chmod(0o755)
    return str(bin_dir)


RECIPES = {  # recipe, the corpus stems it reads, its output and binarized dirs
    "prepare-wmt-en2any.sh": (["training/europarl-v7.de-en", "commoncrawl.de-en",
                               "training/news-commentary-v12.de-en"], "wmt_en_de"),
    "prepare-opus100-en2any.sh": (["opus.en-de", "opus-test.en-de"], "opus_en_de"),
}


@pytest.mark.parametrize("recipe", RECIPES)
def test_prepare_recipe_runs_against_the_port(tmp_path, shim_bin, recipe):
    """The recipe, unchanged, on a tiny corpus (``--subword-tokens 60
    --valid-frac 0.2`` appended: argparse's last wins): the port's
    ``prepare_wmt`` and ``preprocess`` write a binarized directory whose
    every file equals the JAX ``preprocess``'s on the same text."""
    stems, out_name = RECIPES[recipe]
    root = tmp_path / "data"
    for i, stem in enumerate(stems):
        _corpus(root / "orig", stem, n_rep=1 if "test" in stem else 4, shift=i)
    env = dict(os.environ)
    env["PATH"] = shim_bin + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["DATA_ROOT"] = str(root)
    proc = subprocess.run(["bash", str(REPO / "recipes" / recipe), "de", "--subword-tokens",
                           "60", "--valid-frac", "0.2"], env=env, cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    text = root / out_name
    assert (text / "codes.en-de").is_file() and (text / "test.de").stat().st_size > 0
    want_dir = tmp_path / "jax_bin"
    jax_preprocess.main(["-s", "en", "-t", "de", "--joined-dictionary",
                         "--trainpref", str(text / "train"), "--validpref", str(text / "valid"),
                         "--testpref", str(text / "test"), "--destdir", str(want_dir)])
    got, want = _files(root / "bin_en_de"), _files(want_dir)
    assert sorted(got) == sorted(want) and any(k.endswith(".bin") for k in got)
    for k in want:
        assert got[k] == want[k], k
