"""The ST fine-tune recipe, ``recipes/train-en2any-ST.sh`` unchanged, run
against the port on the CPU: console-script shims point ``chimera-train``,
``chimera-generate`` and ``chimera-auto-generate`` at the port's modules.

The run is the recipe chain's third stage (``tests/torch_recipe_runs.py``,
shared with ``tests/test_torch_recipe_chain.py``): a tiny seeded
fairseq-layout wav2vec2 ``.pt`` stands in for ``wav2vec_small.pt`` (the
recipe's ``--w2v2-model-path``), and ``MT_CKPT`` is the best checkpoint of
the chain's MT stage, trained by the port through
``recipes/train-en2any-MT.sh`` on seeded parallel text binarized against the
fixture's dictionary. The recipe copies ``MT_CKPT`` to
``checkpoint_last.ckpt`` and restores it with ``--reset-optimizer``, so the
update count restarts at 0 and ends at ``MAX_UPDATE`` = 4; its background
auto-evaluator decodes each new checkpoint and stops on the flag the
recipe's exit trap raises."""

import pickle
from pathlib import Path

import pytest

from tests.torch_recipe_runs import recipe_stages


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    return recipe_stages(tmp_path_factory)


def test_st_recipe_runs_against_the_port(stages):
    mt_best = Path(stages["mt_dir"]) / "checkpoint_best.ckpt"
    mt = _load(mt_best)
    assert mt["step"] in (4, 8)  # the MT stage's best epoch
    assert mt["extra"]["task_cfg"]["_name"] == "translation"

    st_dir = Path(stages["st_dir"])
    trace = stages["traces"]["st"]
    # the warm start: MT best copied to ST last, restored with a fresh optimizer
    assert f"cp {mt_best}" in trace.replace("'", "")
    assert "--reset-optimizer" in trace
    assert "loaded pretrained wav2vec2" in trace
    assert f"restored {st_dir / 'checkpoint_last.ckpt'} (epoch 3, 0 updates)" in trace
    last = _load(st_dir / "checkpoint_last.ckpt")
    assert last["step"] == 4  # fresh optimizer: 0 + MAX_UPDATE, not MT's 8 + 4
    assert last["extra"]["model_cfg"]["arch"] == "s2t_transformer_w2v2_interlingua_base"
    assert last["opt_state"]["0"]["count"] == 4
    # the auto-evaluator decoded the new checkpoints, then stopped on the flag
    reports = sorted((st_dir / "auto_eval").glob("checkpoint*.valid.txt"))
    assert reports, trace[-4000:]
    assert any("Generate valid with beam=2" in r.read_text() for r in reports)
    assert "suicide flag" in trace and (st_dir / "auto_gen_stop").is_file()
