"""Training the slice's tasks in the port against the JAX package on the
CPU: the batches of every new task array for array over two epochs (the
denoising noise re-rolled, the resampled epochs re-drawn, every batch of
one language pair), ``cli.train`` of each task in the port, and the
checkpoint carried across both ways (a JAX-written train state resumed by
the port's train CLI, whose checkpoint the JAX ``load_state`` restores)
for BART with its classification head and the multilingual tree with and
without sharing. The updates are ``tests/test_torch_bart_updates.py``'s.

Data: ``tests/test_torch_bart.py`` ``make_bart_data`` (a 37-word
vocabulary). Widths: 2 + 2 layers, 32 wide, 4 heads, every dropout 0.
Tolerances: batches identical; parameters of the resumed run compared by
the JAX restore bit for bit.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import load_state as jax_load_state
from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.cli import train
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.tasks import setup_task
from tests.test_torch_bart import MBART_LANGS, WIDTHS, data  # noqa: F401 — the data fixture
from tests.test_torch_models import numpy_tree
from tests.test_torch_mt import _load, jax_serialized

BART_NOISE = {"mask": 0.3, "mask_random": 0.1, "poisson_lambda": 3.5, "permute_sentences": 1.0,
              "replace_length": 1, "tokens_per_sample": 32}
# case -> (data key, task config, model config, criterion config)
TASKS = {
    "denoising": ("mono", {"_name": "denoising", **BART_NOISE},
                  {"arch": "bart_base"}, {"_name": "label_smoothed_cross_entropy"}),
    "denoising_insert_rotate": ("mono", {"_name": "denoising", "mask": 0.2, "mask_random": 0.5,
                                         "insert": 0.2, "rotate": 1.0, "poisson_lambda": 0.0,
                                         "replace_length": -1, "tokens_per_sample": 24},
                                {"arch": "bart_base"}, {"_name": "label_smoothed_cross_entropy"}),
    "multilingual_denoising": ("mono", {"_name": "multilingual_denoising", "langs":
                                        "en_XX,ro_RO", "multilang_sampling_alpha": 0.7,
                                        **BART_NOISE},
                               {"arch": "mbart_base"}, {"_name": "label_smoothed_cross_entropy"}),
    "translation_from_pretrained_bart": (
        "mt", {"_name": "translation_from_pretrained_bart", "source_lang": "en_XX",
               "target_lang": "ro_RO", "langs": MBART_LANGS},
        {"arch": "mbart_base"}, {"_name": "label_smoothed_cross_entropy"}),
    "translation_multi_simple_epoch": (
        "mt", {"_name": "translation_multi_simple_epoch", "lang_pairs": "de-en,fr-en",
               "encoder_langtok": "src", "decoder_langtok": True, "sampling_temperature": 2.0},
        {"arch": "transformer"}, {"_name": "label_smoothed_cross_entropy"}),
    "multilingual_translation": (
        "mt", {"_name": "multilingual_translation", "lang_pairs": "de-en,fr-en"},
        {"arch": "multilingual_transformer_iwslt_de_en", "share_decoders": True},
        {"_name": "multilingual_label_smoothed_cross_entropy"}),
    "sentence_prediction": ("glue", {"_name": "sentence_prediction", "num_classes": 2},
                            {"arch": "bart_base"}, {"_name": "sentence_prediction"}),
    "sentence_ranking": ("rank", {"_name": "sentence_ranking"}, {"arch": "bart_base"},
                         {"_name": "sentence_ranking"}),
}
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def task_pair(data, case):
    key, cfg, _, _ = TASKS[case]
    cfg = {**cfg, "data": str(data[key])}
    task, jax_task = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    for t in (task, jax_task):
        t.load_dataset("train")
    return task, jax_task


def _same_batch(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", sorted(TASKS))
def test_batches_match_jax_over_two_epochs(data, case):
    """Every batch of epochs 1 and 2 (order, padding, noise, language
    tokens, resampling, labels) array for array against JAX's; the
    denoising noise and the resampled mixtures are drawn anew in epoch 2;
    a multilingual batch holds one pair and the pairs' batches cover every
    sample once."""
    task, jax_task = task_pair(data, case)
    its = [t.make_batch_iterator(t.dataset("train"), max_sentences=6, seed=3,
                                 num_length_buckets=2) for t in (task, jax_task)]
    epochs = []
    for epoch in (1, 2):
        batches = [list(it.next_epoch_itr(shuffle=False)) for it in its]
        for it in its:
            it.next_epoch()
        assert len(batches[0]) == len(batches[1]) > 1
        for got, want in zip(*batches):
            _same_batch(got, want, f"{case} epoch {epoch}")
        epochs.append(batches[0])
    ids = [np.concatenate([b["id"] for b in bs]) for bs in epochs]
    if case.startswith("denoising") or case == "multilingual_denoising":
        assert any(not np.array_equal(a["src_tokens"], b["src_tokens"])
                   for a, b in zip(*epochs))
    if case in ("multilingual_denoising", "translation_multi_simple_epoch"):
        assert not np.array_equal(np.sort(ids[0]), np.sort(ids[1])) or \
            any(not np.array_equal(a["target"], b["target"]) for a, b in zip(*epochs))
    if case == "multilingual_translation":
        per_pair = {}  # a pair's sample ids are its own dataset's
        for b in epochs[0]:
            per_pair.setdefault(b["task_name"], []).extend(b["id"].tolist())
        assert {k: sorted(v) for k, v in per_pair.items()} == {
            "de-en": list(range(16)), "fr-en": list(range(10))}


def test_language_tokens_as_fairseq_places_them(data):
    """mBART: source ends ``[en_XX]``, target ends ``[ro_RO]``, which leads
    ``prev_output_tokens``; multi-simple-epoch: ``__de__`` / ``__fr__``
    leads the source, ``__en__`` the decoder input."""
    task, _ = task_pair(data, "translation_from_pretrained_bart")
    d = task.target_dictionary
    b = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=4)
                  .next_epoch_itr(shuffle=False)))
    rows = range(len(b["id"]))
    src_last = [b["src_tokens"][r][b["src_tokens"][r] != 1][-1] for r in rows]
    tgt_last = [b["target"][r][b["target"][r] != 1][-1] for r in rows]
    assert set(src_last) == {d.index("[en_XX]")} and set(tgt_last) == {d.index("[ro_RO]")}
    assert set(b["prev_output_tokens"][:, 0]) == {d.index("[ro_RO]")}
    assert len(d) == 4 + 37 + 3 + 1 and d[len(d) - 1] == "<mask>"
    task, _ = task_pair(data, "translation_multi_simple_epoch")
    d = task.target_dictionary
    b = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=40)
                  .next_epoch_itr(shuffle=False)))
    assert set(b["src_tokens"][:, 0]) == {d.index("__de__"), d.index("__fr__")}
    assert set(b["prev_output_tokens"][:, 0]) == {d.index("__en__")}


def train_argv(data, case, save_dir, max_update=2, extra=(), model_cfg=None):
    key, cfg, default_model, crit_cfg = TASKS[case]
    flags = []
    for k, v in {**cfg, **(model_cfg or default_model), **WIDTHS, **NO_DROPOUT}.items():
        if k == "_name" or v is False:
            continue
        flags += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return [str(data[key]), "--task", cfg["_name"], *flags, "--criterion", crit_cfg["_name"],
            "--label-smoothing", "0.1", "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
            "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
            "--batch-size", "6", "--max-update", str(max_update), "--dtype", "float32",
            "--num-length-buckets", "2", "--save-dir", str(save_dir), "--device", "cpu",
            "--log-interval", "1", *extra]


@pytest.mark.parametrize("case", sorted(set(TASKS) - {"denoising_insert_rotate"}))
def test_cli_train_runs_each_task(data, case, tmp_path):
    """``cli.train`` of the task on the CPU: two updates, validation, a
    checkpoint that stores the arch and the task; finite losses. The
    stored task config holds no seed (the train CLI's declared flags do not
    reach the task, in JAX as here: the noise and the resampling are keyed
    by seed 1, ROADMAP C)."""
    out = train.main(train_argv(data, case, tmp_path))
    assert out["trainer"].num_updates == 2
    assert all(np.isfinite(v) for v in out["times"]["valid"])
    payload = _load(tmp_path / "checkpoint_last.ckpt")
    assert payload["step"] == 2
    assert payload["extra"]["model_cfg"]["arch"] == TASKS[case][2]["arch"]
    assert payload["extra"]["task_cfg"]["_name"] == TASKS[case][1]["_name"]
    assert "seed" not in payload["extra"]["task_cfg"]


OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)"}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": 1e-3, "warmup_updates": 2}
ROUND_TRIPS = {
    "bart_head": ("sentence_prediction", {}),
    "multi": ("multilingual_translation", {"share_decoders": False}),
    "multi_shared": ("multilingual_translation", {"share_encoders": True,
                                                  "share_decoders": True}),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_checkpoints_cross_both_ways(data, name, tmp_path, caplog):
    """A JAX train state (the JAX CLI's init and Adam) saved by the JAX
    store resumes in the port's ``cli.train`` for two updates; the JAX
    ``load_state`` restores the port's checkpoint into the JAX template
    without an optimizer reset: the step, every parameter and Adam
    moment as the port holds them. The multilingual tree has no decoder
    under its encoder groups."""
    case, share = ROUND_TRIPS[name]
    key, cfg, model_cfg, _ = TASKS[case]
    model_cfg = {**model_cfg, **share, **WIDTHS, **NO_DROPOUT}
    jax_task = jax_setup_task({**cfg, "data": str(data[key])})
    jax_task.load_dataset("train")
    jm = jax_task.build_model(dict(model_cfg))

    class _Args:
        seed = 1
        w2v2_model_path = None

    template = jax_train.init_params_for_task(jm, jax_task, _Args())
    groups = set(template["params"])
    if case == "multilingual_translation":
        assert not any("decoder" in template["params"][g] for g in groups if g.startswith("enc_"))
        assert ("enc_shared" in groups) == bool(share.get("share_encoders"))
    else:
        assert {"backbone", "classification_dense", "classification_out"} == groups
    tx = jax_build_optimizer(OPT_CFG, jax_build_lr_schedule(SCHED_CFG))
    start = create_train_state(template, tx)
    tmp_path.joinpath("run").mkdir()
    jax_save_state(str(tmp_path / "run" / "checkpoint_last.ckpt"), start,
                   {"model_cfg": {k: v for k, v in model_cfg.items()},
                    "task_cfg": {**cfg, "data": str(data[key])}})
    out = train.main(train_argv(data, case, tmp_path / "run", 2, ["--disable-validation"],
                                {**TASKS[case][2], **share}))
    assert out["times"]["restored"]["step"] == 0 and out["trainer"].num_updates == 2
    kind = {"sentence_prediction": "bart"}.get(case, "multilingual_transformer")
    with caplog.at_level(logging.WARNING):
        state, _ = jax_load_state(str(tmp_path / "run" / "checkpoint_last.ckpt"), start)
    assert not [r for r in caplog.records if "optimizer state" in r.getMessage()]
    assert int(state.step) == 2
    trainer = out["trainer"]
    held = trainer.model.state_dict()
    restored = params_from_flax(numpy_tree(state.params), kind)
    assert set(restored) == set(held)
    for k, v in restored.items():
        assert torch.equal(v, held[k]), k
    moments, count, _ = trainer.optimizer.read_optax(
        jax.tree_util.tree_map(np.asarray, jax_serialized(state.opt_state)), trainer.model)
    assert count == 2
    for n, p in trainer.model.named_parameters():
        assert torch.equal(moments["mu"][n], trainer.optimizer.optimizer.state[p]["exp_avg"]), n
