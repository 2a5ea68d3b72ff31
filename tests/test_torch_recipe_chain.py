"""The whole recipe chain against the port on the CPU, the counterpart of
``tests/test_recipe_chain.py``: the scripts of ``recipes/`` run unchanged,
with console-script shims that point ``chimera-preprocess``,
``chimera-train``, ``chimera-generate``, ``chimera-auto-generate`` and
``chimera-average-checkpoints`` at the port's modules. Stages 1-3
(binarize, ``recipes/train-en2any-MT.sh``, ``recipes/train-en2any-ST.sh``
warm-started from the MT best) are ``tests/torch_recipe_runs.py``'s run,
shared with ``tests/test_torch_recipe.py``; this file checks them, then
runs stage 4, ``recipes/generate-mustc-final.sh``: the ST epoch checkpoints
averaged, then the final decode and its BLEU line.

Tiny flags appended after each recipe's own win (argparse: last wins).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest

from chimera_st_tpu_torch.optim import freeze
from tests.torch_recipe_runs import RECIPES, env, recipe_stages, run


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _flat(t, path=()):
    if isinstance(t, dict) and t:
        for k in sorted(t):
            yield from _flat(t[k], path + (k,))
    else:
        yield path, t


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    return recipe_stages(tmp_path_factory)


def test_recipe_chain_runs_against_the_port(tmp_path, stages):
    pytest.importorskip("sacrebleu", reason="the final eval scores with --scoring sacrebleu")
    triplet, shim_bin = stages["triplet"], stages["shim_bin"]

    # 1. binarize against the joint dictionary
    bin_dir = Path(stages["bin_dir"])
    assert (bin_dir / "train.en-de.en.bin").is_file()

    # 2. the MT stage: 32 pairs in batches of 8, 4 updates an epoch, 2 epochs
    mt_dir = Path(stages["mt_dir"])
    trace = stages["traces"]["mt"]
    assert "freezing fix_audio_trunk (" in trace
    mt_best = mt_dir / "checkpoint_best.ckpt"
    mt = _load(mt_best)
    assert mt["extra"]["task_cfg"]["_name"] == "translation"
    assert _load(mt_dir / "checkpoint_last.ckpt")["step"] == 8
    assert sorted(p.name for p in mt_dir.glob("checkpoint[0-9]*.ckpt")) == \
        ["checkpoint1.ckpt", "checkpoint2.ckpt"]
    # the masked optimizer tree: the trunk's moments are empty leaves
    inner = mt["opt_state"]["inner_states"]
    assert inner["freeze"] == {"inner_state": {}}
    mu = inner["train"]["inner_state"]["0"]["mu"]["params"]
    assert mu["wav2vec_model"]["post_extract_proj"]["kernel"] == {}
    assert np.asarray(mu["decoder"]["layer_norm"]["scale"]).any()

    # 3. the ST stage warm-started from the port's MT best
    st_dir = Path(stages["st_dir"])
    trace = stages["traces"]["st"]
    assert f"cp {mt_best}" in trace.replace("'", "")
    assert "--reset-optimizer" in trace
    assert f"restored {st_dir / 'checkpoint_last.ckpt'} (epoch 3, 0 updates)" in trace
    last = _load(st_dir / "checkpoint_last.ckpt")
    assert last["step"] == 4 and last["extra"]["task_cfg"]["_name"] == "triplet"
    # the triplet task is not text-only: no mask, every parameter has moments
    assert set(last["opt_state"]) == {"0", "1"}
    epoch_ckpts = sorted(st_dir.glob("checkpoint[0-9]*.ckpt"))
    # the epoch count goes on from the MT stage's (no --reset-dataloader)
    assert [p.name for p in epoch_ckpts] == ["checkpoint3.ckpt", "checkpoint4.ckpt"]
    reports = sorted((st_dir / "auto_eval").glob("checkpoint*.valid.txt"))
    assert reports and any("Generate valid with beam=2" in r.read_text() for r in reports)
    assert "suicide flag" in trace and (st_dir / "auto_gen_stop").is_file()

    # 4. the final evaluation: average the epoch files, decode, score
    out = tmp_path / "final_eval"
    trace = run(["bash", str(RECIPES / "generate-mustc-final.sh"), "--batch-size", "4",
                 "--dtype", "float32", "--max-decode-len", "8", "--num-length-buckets", "2",
                 "--cpu"],
                env(shim_bin, DATA_DIR=triplet, SAVE_DIR=st_dir, OUT=out, GEN_SUBSET="test"))
    assert f"averaged 2 checkpoints -> {out / 'averaged.ckpt'}" in trace
    assert "Generate test with beam=10" in trace
    avg = dict(_flat(_load(out / "averaged.ckpt")["params"]))
    a, b = (dict(_flat(_load(p)["params"])) for p in epoch_ckpts)
    assert sorted(avg) == sorted(a)
    for k, m in avg.items():
        np.testing.assert_array_equal(m, ((np.asarray(a[k], np.float64) + b[k]) / 2)
                                      .astype(np.float32), err_msg="/".join(k))
    text = (out / "generate-test.txt").read_text()
    assert text.count("\nH-") + text.startswith("H-") == 8


def test_trunk_mask_names_only_audio_modules():
    """The mask the MT stage applies is the trunk (wav2vec2, subsampler,
    audio-only encoder layers) and nothing of the text branch."""
    from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, InterlinguaConfig

    model = ChimeraInterlinguaModel(InterlinguaConfig(
        tgt_vocab_size=24, src_vocab_size=24, encoder_embed_dim=16, encoder_ffn_dim=32,
        encoder_layers=2, encoder_heads=2, decoder_embed_dim=16, decoder_ffn_dim=32,
        decoder_layers=1, decoder_heads=2, interlingua_length=4, interlingua_layers=1,
        conv_channels=8, w2v2_embed_dim=16, w2v2_ffn_dim=32, w2v2_layers=1, w2v2_heads=2,
        w2v2_conv_spec=((8, 10, 5), (12, 3, 2)), w2v2_conv_pos=8, w2v2_conv_pos_groups=4,
        non_shared_encoder_layers=1), device="cpu")
    labels = freeze.freeze_labels(model, ("fix_audio_trunk",))
    frozen = {n for n, lab in labels.items() if lab == "freeze"}
    assert frozen == {n for n in labels if n.startswith((
        "encoder.wav2vec_model.", "encoder.subsample.", "encoder.audio_exclusive_layers."))}
    assert any(n.startswith("encoder.audio_exclusive_layers.") for n in frozen)
