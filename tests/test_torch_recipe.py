"""The ST fine-tune recipe, ``recipes/train-en2any-ST.sh`` unchanged, run
against the port on the CPU: console-script shims point ``chimera-train``,
``chimera-generate`` and ``chimera-auto-generate`` at the port's modules.

A tiny seeded fairseq-layout wav2vec2 ``.pt`` stands in for
``wav2vec_small.pt`` (the recipe's ``--w2v2-model-path``). ``MT_CKPT`` is
the MT stage's best checkpoint, trained by the port: seeded parallel text
binarized against the fixture's dictionary by the port's preprocess, then
the port's train CLI on ``--task translation`` for 2 updates. Tiny flags
appended after the recipe's own win (argparse: last wins). The recipe
copies ``MT_CKPT`` to ``checkpoint_last.ckpt`` and restores it with
``--reset-optimizer``, so the update count restarts at 0 and ends at
``MAX_UPDATE`` = 2; its background auto-evaluator decodes each new
checkpoint and stops on the flag the recipe's exit trap raises."""

import os
import pickle
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from chimera_st_tpu_torch.cli import preprocess, train
from tests.synthetic_data import TINY_ARCH_FLAGS, make_parallel_text, make_triplet_dir
from tests.torch_reference import TorchW2V2

REPO = Path(__file__).resolve().parents[1]
SHIMS = {
    "chimera-train": "chimera_st_tpu_torch.cli.train",
    "chimera-generate": "chimera_st_tpu_torch.cli.generate",
    "chimera-auto-generate": "chimera_st_tpu_torch.tools.auto_generate",
}
TINY_EXTRA = [*TINY_ARCH_FLAGS, "--dtype", "float32", "--log-interval", "1",
              "--num-length-buckets", "2", "--batch-size", "4", "--warmup-updates", "2", "--cpu"]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def shim_bin(tmp_path_factory):
    bin_dir = tmp_path_factory.mktemp("bin")
    for name, mod in SHIMS.items():
        sh = bin_dir / name
        sh.write_text(f'#!/usr/bin/env bash\nexec {sys.executable} -m {mod} "$@"\n')
        sh.chmod(0o755)
    return str(bin_dir)


def test_st_recipe_runs_against_the_port(tmp_path, shim_bin):
    data = make_triplet_dir(str(tmp_path / "mustc"))
    torch.manual_seed(0)
    w2v2 = TorchW2V2(((8, 10, 5), (12, 3, 2)), 16, 32, 1, 2, 8, 4)
    w2v2_pt = tmp_path / "wav2vec_tiny.pt"
    torch.save({"args": Namespace(encoder_embed_dim=16), "model": w2v2.state_dict()},
               str(w2v2_pt))

    raw = make_parallel_text(str(tmp_path / "wmt_raw"))
    bin_dir = str(tmp_path / "bin")
    preprocess.main(["-s", "en", "-t", "de", "--trainpref", f"{raw}/train",
                     "--validpref", f"{raw}/valid", "--destdir", bin_dir,
                     "--srcdict", f"{data}/dict.txt", "--tgtdict", f"{data}/dict.txt"])
    mt_dir = tmp_path / "mt"
    train.main([bin_dir, "--task", "translation", "-s", "en", "-t", "de", *TINY_ARCH_FLAGS,
                "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
                "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
                "--batch-size", "4", "--max-update", "2", "--dtype", "float32",
                "--num-length-buckets", "2", "--save-dir", str(mt_dir), "--device", "cpu"])
    mt_best = mt_dir / "checkpoint_best.ckpt"
    assert _load(mt_best)["step"] == 2
    assert _load(mt_best)["extra"]["task_cfg"]["_name"] == "translation"

    st_dir = tmp_path / "st"
    env = dict(os.environ)
    env["PATH"] = shim_bin + os.pathsep + env["PATH"]
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(DATA_DIR=data, SAVE_DIR=str(st_dir), MT_CKPT=str(mt_best), W2V2=str(w2v2_pt),
               MAX_UPDATE="2", UPDATE_FREQ="1", INTERLINGUA_LENGTH="4", GEN_SUBSET="valid",
               AUTOGEN_EXTRA="--poll-interval 1 --batch-size 4 --beam 2 --max-decode-len 8 "
                             "--dtype float32 --num-length-buckets 2 --cpu")
    proc = subprocess.run(["bash", "-x", str(REPO / "recipes" / "train-en2any-ST.sh"),
                           *TINY_EXTRA], env=env, cwd=str(REPO), capture_output=True, text=True,
                          timeout=600)
    trace = proc.stderr + "\n" + proc.stdout
    assert proc.returncode == 0, trace[-6000:]
    # the warm start: MT best copied to ST last, restored with a fresh optimizer
    assert f"cp {mt_best}" in trace.replace("'", "")
    assert "--reset-optimizer" in trace
    assert "loaded pretrained wav2vec2" in trace
    assert f"restored {st_dir / 'checkpoint_last.ckpt'} (epoch 2, 0 updates)" in trace
    last = _load(st_dir / "checkpoint_last.ckpt")
    assert last["step"] == 2  # fresh optimizer: 0 + MAX_UPDATE, not MT's 2 + 2
    assert last["extra"]["model_cfg"]["arch"] == "s2t_transformer_w2v2_interlingua_base"
    assert last["opt_state"]["0"]["count"] == 2
    # the auto-evaluator decoded the new checkpoints, then stopped on the flag
    reports = sorted((st_dir / "auto_eval").glob("checkpoint*.valid.txt"))
    assert reports, trace[-4000:]
    assert any("Generate valid with beam=2" in r.read_text() for r in reports)
    assert "suicide flag" in trace and (st_dir / "auto_gen_stop").is_file()
