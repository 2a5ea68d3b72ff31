"""The recipe chain's first three stages against the port, run once per
test session and shared by ``tests/test_torch_recipe_chain.py`` and
``tests/test_torch_recipe.py``: the scripts of ``recipes/`` unchanged, with
console-script shims that point ``chimera-preprocess``, ``chimera-train``,
``chimera-generate``, ``chimera-auto-generate`` and
``chimera-average-checkpoints`` at the port's modules.

1. binarize seeded parallel text against the triplet fixture's dictionary
   (``chimera-preprocess --srcdict --tgtdict``, so that the MT checkpoint's
   embeddings fit the ST stage);
2. ``recipes/train-en2any-MT.sh``: the translation task, the audio trunk
   masked out of Adam, 8 updates over 2 epochs;
3. ``recipes/train-en2any-ST.sh`` warm-started from the MT stage's
   ``checkpoint_best.ckpt`` (copied to ``checkpoint_last.ckpt``, restored
   with ``--reset-optimizer``) with a tiny seeded fairseq-layout wav2vec2
   ``.pt`` as ``--w2v2-model-path``, 4 updates, its background
   auto-evaluator decoding each new checkpoint.

Tiny flags appended after each recipe's own win (argparse: last wins).
Under pytest-xdist the workers share the run through a lock file in the
session's common temporary directory: the first worker to ask runs the
stages, the others wait for it and read its results."""

import fcntl
import json
import os
import subprocess
import sys
import traceback
from argparse import Namespace
from pathlib import Path

import torch

from tests.synthetic_data import TINY_ARCH_FLAGS, make_parallel_text, make_triplet_dir
from tests.torch_reference import TorchW2V2

REPO = Path(__file__).resolve().parents[1]
RECIPES = REPO / "recipes"
SHIMS = {
    "chimera-preprocess": "chimera_st_tpu_torch.cli.preprocess",
    "chimera-train": "chimera_st_tpu_torch.cli.train",
    "chimera-generate": "chimera_st_tpu_torch.cli.generate",
    "chimera-auto-generate": "chimera_st_tpu_torch.tools.auto_generate",
    "chimera-average-checkpoints": "chimera_st_tpu_torch.tools.average_checkpoints",
}
TINY_EXTRA = [*TINY_ARCH_FLAGS, "--dtype", "float32", "--log-interval", "1",
              "--num-length-buckets", "2", "--cpu"]


def env(shim_bin, **extra):
    out = dict(os.environ)
    out["PATH"] = str(shim_bin) + os.pathsep + out["PATH"]
    out["PYTHONPATH"] = str(REPO) + os.pathsep + out.get("PYTHONPATH", "")
    out.update({k: str(v) for k, v in extra.items()})
    return out


def run(cmd, environ, timeout=600):
    proc = subprocess.run(cmd, env=environ, cwd=str(REPO), capture_output=True, text=True,
                          timeout=timeout)
    trace = proc.stderr + "\n" + proc.stdout
    assert proc.returncode == 0, f"{cmd} failed rc={proc.returncode}\n{trace[-6000:]}"
    return trace


def _stages(root: Path) -> dict:
    shim_bin = root / "bin"
    shim_bin.mkdir(parents=True)
    for name, mod in SHIMS.items():
        sh = shim_bin / name
        sh.write_text(f'#!/usr/bin/env bash\nexec {sys.executable} -m {mod} "$@"\n')
        sh.chmod(0o755)
    triplet = make_triplet_dir(str(root / "mustc"))
    raw = make_parallel_text(str(root / "wmt_raw"))

    # 1. binarize against the joint dictionary
    bin_dir = root / "data_bin"
    preprocess = run(["chimera-preprocess", "-s", "en", "-t", "de", "--trainpref",
                      f"{raw}/train", "--validpref", f"{raw}/valid", "--destdir", str(bin_dir),
                      "--srcdict", f"{triplet}/dict.txt", "--tgtdict", f"{triplet}/dict.txt"],
                     env(shim_bin))

    # 2. the MT stage: 32 pairs in batches of 8, 4 updates an epoch, 2 epochs
    mt_dir = root / "mt"
    mt = run(["bash", str(RECIPES / "train-en2any-MT.sh"), *TINY_EXTRA, "--batch-size", "8",
              "--warmup-updates", "2"],
             env(shim_bin, DATA_BIN=bin_dir, SAVE_DIR=mt_dir, TGT="de", INTERLINGUA_LENGTH=4,
                 MAX_UPDATE=8, UPDATE_FREQ=1))

    # 3. the ST stage warm-started from the port's MT best
    torch.manual_seed(0)
    w2v2 = TorchW2V2(((8, 10, 5), (12, 3, 2)), 16, 32, 1, 2, 8, 4)
    w2v2_pt = root / "wav2vec_tiny.pt"
    torch.save({"args": Namespace(encoder_embed_dim=16), "model": w2v2.state_dict()},
               str(w2v2_pt))
    st_dir = root / "st"
    st = run(["bash", "-x", str(RECIPES / "train-en2any-ST.sh"), *TINY_EXTRA,
              "--batch-size", "4", "--warmup-updates", "2"],
             env(shim_bin, DATA_DIR=triplet, SAVE_DIR=st_dir, MT_CKPT=mt_dir /
                 "checkpoint_best.ckpt", W2V2=w2v2_pt, MAX_UPDATE=4, UPDATE_FREQ=1,
                 INTERLINGUA_LENGTH=4, GEN_SUBSET="valid",
                 AUTOGEN_EXTRA="--poll-interval 1 --batch-size 4 --beam 2 "
                               "--max-decode-len 8 --dtype float32 "
                               "--num-length-buckets 2 --cpu"))
    return {"shim_bin": str(shim_bin), "triplet": triplet, "bin_dir": str(bin_dir),
            "mt_dir": str(mt_dir), "st_dir": str(st_dir), "w2v2_pt": str(w2v2_pt),
            "traces": {"preprocess": preprocess, "mt": mt, "st": st}}


def recipe_stages(tmp_path_factory) -> dict:
    """The three stages' directories (as strings) and traces, from the run
    this session shares. A failed run raises in every test that asks."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    root = shared / "torch_recipe_stages"
    result = shared / "torch_recipe_stages.json"
    with open(shared / "torch_recipe_stages.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not result.exists():
                try:
                    out = {"ok": True, **_stages(root)}
                except Exception:  # every asker sees the failure and its traceback
                    out = {"ok": False, "error": traceback.format_exc()}
                result.write_text(json.dumps(out))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    out = json.loads(result.read_text())
    assert out["ok"], out["error"]
    return out
