"""The MT pre-training stage of the port against the JAX package on the CPU:
binarization, the translation task's batches, the text-only update with the
audio trunk masked out of Adam, MT checkpoints across the two packages,
decoding, BLEU validation on text, averaging, ``--async-dispatch``,
comma-joined training splits and ``--dump-feature-to-file``.

A module fixture binarizes ``make_parallel_text`` with the JAX package's
preprocess and runs the JAX train CLI once on it (``--task translation``,
the tiny architecture, every dropout 0, Adam (0.9, 0.98) with eps 1e-3,
``inverse_sqrt`` lr 1e-3 over 2 warm-up updates, batches of 8: 4 updates an
epoch, 6 updates, a save every 3, BLEU as the best metric), so that
``checkpoint_1_3.ckpt`` falls in the middle of epoch 1. The port's train
CLI then resumes a copy of that checkpoint to update 6.

Tolerances (fp32; the rules of ``tests/test_torch_train.py`` and
``tests/test_torch_train_cli.py``): parameters 1e-4 of the learning rate
plus two fp32 roundings (2^-22 relative); Adam's moments 1e-4 of each
tensor's largest value; losses, gnorm and logged scalars 1e-5 relative;
decoded tokens and binarized files identical.
"""

import ast
import dataclasses
import filecmp
import json
import logging
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint import torch_import as jax_import
from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.cli import preprocess as jax_preprocess
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.cli import validate as jax_validate
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.data import indexed_dataset as jax_indexed
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.optim import freeze as jax_freeze
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.tools import average_checkpoints as jax_average
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.cli import generate, preprocess, train, validate
from chimera_st_tpu_torch.convert import params_from_flax, params_to_flax
from chimera_st_tpu_torch.data import indexed_dataset
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer, freeze
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.tools import average_checkpoints
from chimera_st_tpu_torch.train import Trainer, TrainStep
from tests.synthetic_data import TINY_ARCH_FLAGS, make_parallel_text, make_triplet_dir
from tests.test_interlingua_model import TINY
from tests.test_torch_checkpoint import fairseq_state_dict
from tests.test_torch_models import numpy_tree, port_model

LR = 1e-3
NO_DROPOUT = ["--dropout", "0", "--attention-dropout", "0", "--activation-dropout", "0",
              "--w2v2-dropout", "0", "--w2v2-attention-dropout", "0",
              "--w2v2-activation-dropout", "0"]
RUN = [*TINY_ARCH_FLAGS, *NO_DROPOUT, "-s", "de", "-t", "en",
       "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
       "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-3", "--lr", str(LR),
       "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--batch-size", "8",
       "--max-update", "6", "--save-interval-updates", "3", "--dtype", "float32",
       "--num-length-buckets", "2", "--best-checkpoint-metric", "bleu",
       "--maximize-best-checkpoint-metric", "--log-format", "json", "--log-interval", "1"]
TIMED = {"ups", "wps"}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _flat(t, path=()):
    """(path, leaf) pairs; an empty dict (a masked optax leaf) is a leaf."""
    if isinstance(t, dict) and t:
        for k in sorted(t):
            yield from _flat(t[k], path + (k,))
    else:
        yield path, t


class _Lines(logging.Handler):
    """Collects the json progress lines of one logger, from a run that
    starts without the meters an earlier run of this process left in either
    package's global aggregators (as a run of its own process does)."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.lines = []
        self.logger = logging.getLogger(name)

    def emit(self, record):
        self.lines.append(json.loads(record.getMessage()))

    def __enter__(self):
        from chimera_st_tpu.logging import metrics as jax_metrics
        from chimera_st_tpu_torch.logging import metrics

        jax_metrics.reset()
        metrics.reset()
        self.logger.addHandler(self)
        self.level_was = self.logger.level
        self.logger.setLevel(logging.INFO)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level_was)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX MT run 0 -> 6 and the port's resume of its update-3
    checkpoint -> 6: json lines and BLEU validations of both."""
    sacrebleu = pytest.importorskip("sacrebleu", reason="BLEU validation needs sacrebleu")
    work = tmp_path_factory.mktemp("mt")
    raw = make_parallel_text(str(work / "raw"))
    data = str(work / "bin")
    jax_preprocess.main(["-s", "de", "-t", "en", "--trainpref", f"{raw}/train",
                         "--validpref", f"{raw}/valid", "--testpref", f"{raw}/valid",
                         "--destdir", data, "--joined-dictionary"])
    jax_dir, port_dir = work / "jax", work / "port"
    calls, corpus_bleu = [], sacrebleu.corpus_bleu

    def recorded(hyps, refs, *args, **kwargs):
        out = corpus_bleu(hyps, refs, *args, **kwargs)
        calls.append((list(hyps), out.score))
        return out

    sacrebleu.corpus_bleu = recorded
    try:
        with _Lines("chimera_st_tpu.logging.progress_bar") as jax_lines:
            jax_train.main([data, "--task", "translation", *RUN, "--save-dir", str(jax_dir)])
        jax_bleu, calls[:] = list(calls), []
        port_dir.mkdir()
        shutil.copy(jax_dir / "checkpoint_1_3.ckpt", port_dir / "checkpoint_1_3.ckpt")
        with _Lines("chimera_st_tpu_torch.logging.progress_bar") as port_lines:
            out = train.main([data, "--task", "translation", *RUN, "--save-dir", str(port_dir),
                              "--restore-file", "checkpoint_1_3.ckpt", "--device", "cpu"])
        port_bleu = list(calls)
    finally:
        sacrebleu.corpus_bleu = corpus_bleu
    return dict(work=work, raw=raw, data=data, jax_dir=jax_dir, port_dir=port_dir,
                jax_lines=jax_lines, port_lines=port_lines, out=out, jax_bleu=jax_bleu,
                port_bleu=port_bleu)


# ------------------------------------------------------------ binarization

def _zipf_text(root: Path, seed: int = 0):
    """train / valid / test .en / .de lines of Zipf-drawn words (many ties
    of count, some words seen once), 40 lines of 1-12 words."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split, n in (("train", 40), ("valid", 8), ("test", 8)):
        for lang, offset in (("en", 0), ("de", 7)):
            lines = [" ".join(f"w{int(z) + offset}" for z in rng.zipf(1.6, size=rng.integers(1, 13))
                              if z < 60) for _ in range(n)]
            (root / f"{split}.{lang}").write_text("\n".join(lines) + "\n")
    return str(root)


PREPROCESS_CASES = {
    "joined": ["--joined-dictionary"],
    "joined_nwords_threshold": ["--joined-dictionary", "--nwordssrc", "13", "--thresholdsrc", "2"],
    "separate_nwords_threshold": ["--nwordssrc", "11", "--thresholdtgt", "2"],
    "srcdict": ["--srcdict", "{dict}"],
    "srcdict_tgtdict": ["--srcdict", "{dict}", "--tgtdict", "{dict}"],
    "only_source": ["--only-source"],
    "only_source_joined_threshold": ["--only-source", "--joined-dictionary",
                                     "--thresholdsrc", "2"],
}


@pytest.mark.parametrize("case", sorted(PREPROCESS_CASES))
def test_preprocess_writes_the_jax_packages_bytes(tmp_path, case):
    """Every file both preprocess CLIs write, byte for byte: dictionaries
    (count order, ties, ``madeupword`` padding, ``--nwords`` /
    ``--threshold``), ``.bin`` (int32, eos appended) and ``.idx``."""
    raw = _zipf_text(tmp_path / "raw")
    dict_file = tmp_path / "given_dict.txt"
    dict_file.write_text("".join(f"w{i} {100 - i}\n" for i in range(0, 60, 2)))
    extra = [a.replace("{dict}", str(dict_file)) for a in PREPROCESS_CASES[case]]
    if "--only-source" in extra:
        prefs = ["--trainpref", f"{raw}/train.en", "--validpref", f"{raw}/valid.en",
                 "--testpref", f"{raw}/test.en"]
    else:
        prefs = ["-s", "en", "-t", "de", "--trainpref", f"{raw}/train",
                 "--validpref", f"{raw}/valid", "--testpref", f"{raw}/test"]
    for main, out in ((jax_preprocess.main, "jax"), (preprocess.main, "port")):
        main([*prefs, *extra, "--destdir", str(tmp_path / out), "--workers", "2"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == (7 if "--only-source" in extra else 14)
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64, np.uint8])
def test_indexed_dataset_read_and_written_by_both_packages(tmp_path, dtype):
    rng = np.random.default_rng(1)
    items = [rng.integers(0, 200, size=int(n)).astype(dtype) for n in rng.integers(0, 9, 12)]
    writers = {"port": indexed_dataset.MMapIndexedDatasetBuilder,
               "jax": jax_indexed.MMapIndexedDatasetBuilder}
    for name, builder in writers.items():
        b = builder(str(tmp_path / name), dtype=dtype)
        for x in items:
            b.add_item(x)
        b.finalize()
    for suffix in (".bin", ".idx"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()
    for name, reader in (("jax", indexed_dataset.MMapIndexedDataset),
                         ("port", jax_indexed.MMapIndexedDataset)):
        ds = reader(str(tmp_path / name))
        assert len(ds) == len(items) and ds.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(ds.sizes, [len(x) for x in items])
        for got, want in zip((ds[i] for i in range(len(ds))), items):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_translation_batches_equal_the_jax_tasks(runs):
    """The same binarized split through both tasks' iterators (max tokens
    40, three shuffled epochs): the batch order, the padding and every
    array."""
    cfg = {"_name": "translation", "data": runs["data"], "source_lang": None,
           "target_lang": None}
    tasks = (setup_task(dict(cfg)), jax_setup_task(dict(cfg)))
    assert tasks[0].cfg["source_lang"] == tasks[1].cfg["source_lang"] == "de"
    itrs = [t.make_batch_iterator(t.dataset("train"), max_tokens=40, seed=3,
                                  num_length_buckets=3) for t in tasks]
    for epoch in (1, 2, 3):
        got, want = (list(itr.next_epoch_itr(shuffle=epoch > 1)) for itr in itrs)
        assert len(got) == len(want) > 2
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            assert a["src_tokens"].shape[1] % 16 == 0 and a["target"].shape[1] % 16 == 0
            for k in b:
                if isinstance(b[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                else:
                    assert a[k] == b[k], k
        for itr in itrs:
            itr.next_epoch()


# --------------------------------------------------- the text-only update

OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": 1e-3, "warmup_updates": 1}
CLIP = 2.0


def test_text_only_updates_with_the_trunk_mask_match_jax(runs):
    """Two updates of two micro-batches of text, the audio trunk masked out
    of Adam in both packages: loss, gnorm, lr and every parameter against
    ``make_train_step`` with ``wrap_freeze(..., ("fix_audio_trunk",))``;
    the trunk bit-identical and without Adam state; the optimizer trees of
    the same layout and within tolerance."""
    task = setup_task({"_name": "translation", "data": runs["data"]})
    batch = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=4)
                      .next_epoch_itr(shuffle=False)))
    micro = []
    for rows in (slice(0, 2), slice(2, 4)):
        half = {k: v[rows] for k, v in batch.items() if isinstance(v, np.ndarray)}
        half["ntokens"] = float((half["target"] != 1).sum())
        half["nsentences"] = 2
        micro.append(half)
    cfg = dataclasses.replace(TINY, tgt_vocab_size=len(task.target_dictionary),
                              src_vocab_size=len(task.source_dictionary), dropout=0.0,
                              attention_dropout=0.0, activation_dropout=0.0)
    weights = {"params": jax_import.import_interlingua_state_dict(fairseq_state_dict(cfg, 2)[1])}
    crit_cfg = {"_name": "label_smoothed_cross_entropy", "label_smoothing": 0.1}
    fixes = jax_freeze.auto_text_only_fixes(task, weights)
    assert fixes == ("fix_audio_trunk",)
    sched = jax_build_lr_schedule(SCHED_CFG)
    tx = jax_freeze.wrap_freeze(jax_build_optimizer(OPT_CFG, sched, clip_norm=CLIP), weights,
                                fixes)
    jax_step = make_train_step(JaxModel(cfg), JAX_CRITERIONS.get(crit_cfg["_name"])(
        {**crit_cfg, "padding_idx": 1}), tx, accum_steps=2, lr_schedule=sched, donate=False)
    state = create_train_state(weights, tx)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]
               if k not in ("nsentences", "id")}

    model = port_model(cfg, weights).train()
    assert freeze.auto_text_only_fixes(task, model) == fixes
    trained, frozen = freeze.wrap_freeze(model, fixes)
    trunk = {n for n, p in model.named_parameters() if any(p is f for f in frozen)}
    assert trunk and all(n.startswith(("encoder.wav2vec_model.", "encoder.subsample.",
                                       "encoder.audio_exclusive_layers.")) for n in trunk)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(OPT_CFG, trained, clip_norm=CLIP, frozen=frozen)
    step = TrainStep(model, task.build_criterion(crit_cfg), opt, build_lr_schedule(SCHED_CFG),
                     compute_dtype=torch.float32)
    for update in range(2):
        state, want = jax_step(state, stacked, jax.random.PRNGKey(update))
        got = step(micro)
        assert step.num_updates == int(state.step) == update + 1
        for k in ("loss", "nll_loss", "sample_size_total", "gnorm", "lr"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        want_params = params_from_flax(numpy_tree(state.params))
        lr = max(got["lr"], SCHED_CFG["lr"])
        for k, w in want_params.items():
            p = model.state_dict()[k]
            np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-4 * lr, rtol=2.0 ** -22,
                                       err_msg=f"update {update}: {k}")
            if k in trunk:
                assert torch.equal(p, before[k]), k
    assert not any(p in opt.optimizer.state for p in frozen)
    got_tree = opt.state_to_optax(model, 2)
    want_tree = jax.tree_util.tree_map(np.asarray, jax_serialized(state.opt_state))
    g, w = dict(_flat(got_tree)), dict(_flat(want_tree))
    assert sorted(g) == sorted(w)
    for path, b in w.items():
        a = g[path]
        if isinstance(b, dict):  # a masked leaf: {} on both sides
            assert a == b == {}, path
            continue
        assert np.shape(a) == np.shape(b), path
        # a key projection's bias has an exact gradient of 0: its moments
        # are round-off, held against its kernel's
        scale = w[path[:-1] + ("kernel",)] if path[-2:] == ("k_proj", "bias") else b
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * float(np.abs(scale).max()) + 1e-30,
                                   err_msg="/".join(path))
    assert any(isinstance(v, dict) for v in w.values())  # the trunk's {} leaves


def jax_serialized(opt_state):
    from flax import serialization

    return serialization.to_state_dict(opt_state)


def _task_stub(text_only):
    class _Task:
        pass

    _Task.text_only = text_only
    return _Task()


@pytest.mark.parametrize("case", ["translation", "triplet", "labels"])
def test_auto_text_only_fixes_matches_jax(runs, case):
    """The mask fires for a text-only task over the interlingua model and
    nowhere else, and labels the same parameters as the JAX package's
    ``fix_audio_trunk``."""
    weights = numpy_tree({"params": jax_import.import_interlingua_state_dict(
        fairseq_state_dict(TINY, 2)[1])})
    model = port_model(TINY, weights)
    if case == "labels":
        want = dict(_flat(jax_freeze.freeze_labels(weights, ("fix_audio_trunk",))))
        from chimera_st_tpu_torch.convert import torch_to_flax_path

        got = {("params",) + torch_to_flax_path("interlingua", n)[0]: lab
               for n, lab in freeze.freeze_labels(model, ("fix_audio_trunk",)).items()}
        assert got == want and "freeze" in got.values()
        np.testing.assert_allclose(freeze.frozen_fraction(model, ("fix_audio_trunk",)),
                                   jax_freeze.frozen_fraction(weights, ("fix_audio_trunk",)),
                                   rtol=1e-12)
        return
    task = _task_stub(case == "translation")
    assert freeze.auto_text_only_fixes(task, model) == \
        jax_freeze.auto_text_only_fixes(task, weights) == \
        (("fix_audio_trunk",) if case == "translation" else ())


def test_fix_wav2vec_replaces_the_trunk_mask_in_both_clis(runs, tmp_path, caplog):
    """``--fix-wav2vec`` on the translation task: the CLI skips the
    automatic mask, as the JAX CLI does, and the saved optimizer tree is
    the ``fix_wav2vec`` layout (the subsampler keeps its moments)."""
    argv = [runs["data"], "--task", "translation", *RUN, "--max-update", "1", "--fix-wav2vec",
            "--best-checkpoint-metric", "loss", "--no-epoch-checkpoints"]
    with caplog.at_level(logging.INFO):
        jax_train.main([*argv, "--save-dir", str(tmp_path / "jax")])
        train.main([*argv, "--save-dir", str(tmp_path / "port"), "--device", "cpu"])
    freezing = [r.getMessage() for r in caplog.records if r.getMessage().startswith("freezing")]
    assert len(freezing) == 2 and freezing[0] == freezing[1]
    assert freezing[0].startswith("freezing fix_wav2vec (")
    want, got = (_load(tmp_path / d / "checkpoint_last.ckpt")["opt_state"] for d in ("jax", "port"))
    assert sorted(p for p, _ in _flat(got)) == sorted(p for p, _ in _flat(want))
    assert any("subsample" in p and not isinstance(v, dict) for p, v in _flat(got))


# ------------------------------------------------ MT checkpoints across packages

def test_jax_mt_checkpoint_resumes_in_the_port_to_jax_parameters(runs):
    extra = _load(runs["jax_dir"] / "checkpoint_1_3.ckpt")["extra"]
    assert extra["train_iterator"] == {"epoch": 1, "iterations_in_epoch": 3, "shuffle": True}
    assert runs["out"]["times"]["restored"]["step"] == 3
    want_payload, got_payload = (_load(d / "checkpoint_last.ckpt")
                                 for d in (runs["jax_dir"], runs["port_dir"]))
    assert got_payload["step"] == want_payload["step"] == 6
    assert got_payload["extra"]["train_iterator"] == want_payload["extra"]["train_iterator"]
    want, got = params_from_flax(want_payload["params"]), params_from_flax(got_payload["params"])
    start = params_from_flax(_load(runs["jax_dir"] / "checkpoint_1_3.ckpt")["params"])
    held = runs["out"]["trainer"].model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-4 * LR, rtol=2.0 ** -22,
                                   err_msg=k)
        assert torch.equal(got[k], held[k]), k  # written equals held
        if k.startswith(("encoder.wav2vec_model.", "encoder.subsample.")):
            assert torch.equal(got[k], start[k]) and torch.equal(w, start[k]), k
    # the optimizer trees: the masked layout, moments within tolerance
    shapes = {k: tuple(v.shape) for k, v in held.items()}
    frozen = {n for n, lab in freeze.freeze_labels(runs["out"]["trainer"].model,
                                                   ("fix_audio_trunk",)).items()
              if lab == "freeze"}
    trainer = runs["out"]["trainer"]
    (w_state, w_count, w_sched), (g_state, g_count, g_sched) = (
        trainer.optimizer.read_optax(p["opt_state"], trainer.model)
        for p in (want_payload, got_payload))
    assert w_count == g_count == w_sched == g_sched == 6
    for key in ("mu", "nu"):
        assert set(w_state[key]) == set(g_state[key]) == set(shapes) - frozen
        for name, w in w_state[key].items():
            scale = w_state[key][name[:-4] + "weight"] if name.endswith("k_proj.bias") else w
            tol = 1e-4 * float(scale.abs().max()) + 1e-30
            np.testing.assert_allclose(g_state[key][name].numpy(), w.numpy(), atol=tol,
                                       rtol=0, err_msg=f"{name} {key}")


def test_logged_mt_lines_match_jax(runs):
    """The port logs updates 4 to 6 (epoch progress 1.0, 1.25, 1.5); JAX's
    lines for the same updates."""
    jax_lines = {line["update"]: line for line in runs["jax_lines"]}
    assert [float(line["update"]) for line in runs["port_lines"]] == [1.0, 1.25, 1.5]
    for line in runs["port_lines"]:
        want = jax_lines[line["update"]]
        assert set(line) == set(want)
        for key, value in line.items():
            if key not in TIMED:
                np.testing.assert_allclose(float(value), float(want[key]), rtol=1e-5,
                                           err_msg=f"update {line['update']}: {key}")


def test_bleu_validation_on_text_matches_jax(runs):
    """``--best-checkpoint-metric bleu`` on the translation task decodes the
    valid split's ``src_tokens`` (``generate_text``): the resumed port run's
    three validations (updates 4, 6 and 6) give JAX's hypotheses and BLEU,
    and the best metric saved is that BLEU."""
    assert len(runs["jax_bleu"]) == 4 and len(runs["port_bleu"]) == 3
    for (gh, gs), (wh, ws) in zip(runs["port_bleu"], runs["jax_bleu"][1:]):
        assert gh == wh and len(gh) == 8
        assert gs == ws
    want, got = (_load(d / "checkpoint_last.ckpt")["extra"]
                 for d in (runs["jax_dir"], runs["port_dir"]))
    assert got["best"] == want["best"] and got["val_loss"] == want["val_loss"]


def test_port_mt_checkpoint_restores_in_jax_without_reset(runs, caplog):
    """The port's MT ``checkpoint_last.ckpt`` through the JAX ``load_state``
    into a template masked as the JAX CLI masks it: no optimizer-reset
    warning, the port's moments exactly, no moments for the trunk."""
    from chimera_st_tpu.checkpoint.store import load_state

    path = runs["port_dir"] / "checkpoint_last.ckpt"
    extra = _load(path)["extra"]
    task = jax_setup_task(dict(extra["task_cfg"]))
    model = task.build_model(dict(extra["model_cfg"]))

    class _Args:
        seed = 1
        w2v2_model_path = None

    template = jax_train.init_params_for_task(model, task, _Args())
    tx = jax_build_optimizer({"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3},
                             jax_build_lr_schedule({"_name": "inverse_sqrt", "lr": LR,
                                                    "warmup_updates": 2}))
    tx = jax_freeze.wrap_freeze(tx, template, jax_freeze.auto_text_only_fixes(task, template))
    with caplog.at_level(logging.WARNING):
        state, _ = load_state(str(path), create_train_state(template, tx))
    assert not [r for r in caplog.records if "optimizer state" in r.getMessage()]
    assert int(state.step) == 6
    trainer = runs["out"]["trainer"]
    saved = jax.tree_util.tree_map(np.asarray, jax_serialized(state.opt_state))
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    frozen = {n for n, p in trainer.model.named_parameters()
              if any(p is f for f in trainer.optimizer.frozen)}
    restored, count, schedule_count = trainer.optimizer.read_optax(saved, trainer.model)
    assert count == schedule_count == 6
    assert set(restored["mu"]) == set(shapes) - frozen
    for name, p in trainer.model.named_parameters():
        if name in frozen:
            assert p not in trainer.optimizer.optimizer.state
            continue
        s = trainer.optimizer.optimizer.state[p]
        assert torch.equal(restored["mu"][name], s["exp_avg"])
        assert torch.equal(restored["nu"][name], s["exp_avg_sq"])


def _hypotheses(text):
    return sorted(line for line in text.splitlines() if line.startswith(("S-", "T-", "H-")))


def test_generate_translation_tokens_equal_the_jax_clis(runs, tmp_path):
    """``generate --task translation`` of the JAX run's last checkpoint in
    fp32: the same S-/T- lines and hypotheses, scores within 1e-4 (plus
    the printed rounding)."""
    argv = [runs["data"], "--task", "translation", "--path",
            str(runs["jax_dir"] / "checkpoint_last.ckpt"), "--gen-subset", "test",
            "--beam", "3", "--max-decode-len", "10", "--batch-size", "3", "--dtype", "float32",
            "--num-length-buckets", "2", "--scoring", "bleu"]
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_generate.main([*argv, "--results-path", str(tmp_path / "jax")])
    stats = generate.main([*argv, "--results-path", str(tmp_path / "port"), "--device", "cpu"])
    got, want = ((tmp_path / d / "generate-test.txt").read_text() for d in ("port", "jax"))
    assert stats["sentences"] == 8
    g, w = _hypotheses(got), _hypotheses(want)
    assert len(g) == len(w) == 24
    for a, b in zip(g, w):
        if a.startswith("H-"):
            (ia, sa, ha), (ib, sb, hb) = a.split("\t"), b.split("\t")
            assert (ia, ha) == (ib, hb)
            assert abs(float(sa) - float(sb)) <= 1e-4 + 1e-4
        else:
            assert a == b
    assert got.strip().splitlines()[-1] == want.strip().splitlines()[-1]


def test_interactive_translation_matches_generate(runs, tmp_path, capsys):
    """Source sentences from a file through the interactive CLI, one batch:
    the same hypotheses as the generate CLI prints for those rows."""
    from chimera_st_tpu_torch.cli import interactive

    lines = (Path(runs["raw"]) / "valid.de").read_text().splitlines()[:3]
    (tmp_path / "in.txt").write_text("\n".join(lines) + "\n")
    ckpt = str(runs["jax_dir"] / "checkpoint_last.ckpt")
    interactive.main([runs["data"], "--task", "translation", "-s", "de", "-t", "en", "--path",
                      ckpt, "--beam", "3", "--max-decode-len", "10", "--dtype", "float32",
                      "--input", str(tmp_path / "in.txt"), "--buffer-size", "3",
                      "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split("\t")[1] for line in out if line.startswith("S-")] == lines
    hyps = [line for line in out if line.startswith("H-")]
    assert len(hyps) == 3 and all(len(h.split("\t")) == 3 for h in hyps)


def test_average_checkpoints_equals_jax(runs, tmp_path):
    """Both tools over three of the JAX run's files: the same pickle
    content (parameters bit for bit, the rest the last input's)."""
    inputs = [str(runs["jax_dir"] / n) for n in ("checkpoint1.ckpt", "checkpoint_1_3.ckpt",
                                                 "checkpoint_last.ckpt")]
    jax_average.main(["--inputs", *inputs, "--output", str(tmp_path / "jax.ckpt")])
    average_checkpoints.main(["--inputs", *inputs, "--output", str(tmp_path / "port.ckpt")])
    got, want = _load(tmp_path / "port.ckpt"), _load(tmp_path / "jax.ckpt")
    assert sorted(got) == sorted(want)
    g, w = dict(_flat(got["params"])), dict(_flat(want["params"]))
    assert sorted(g) == sorted(w)
    for path, b in w.items():
        assert g[path].dtype == np.float32 == b.dtype
        np.testing.assert_array_equal(g[path], b, err_msg="/".join(path))
    assert got["step"] == want["step"] and got["extra"] == want["extra"]
    key = ("params", "decoder", "layer_norm", "scale")
    parts = [dict(_flat(_load(path)["params"]))[key] for path in inputs]
    mean = (np.asarray(parts[0], np.float64) + parts[1] + parts[2]) / 3
    np.testing.assert_array_equal(g[key], mean.astype(np.float32))
    assert [p for p, _ in _flat(got["opt_state"])] == \
        [p for p, _ in _flat(_load(inputs[-1])["opt_state"])]


# ------------------------------------------------------------- async dispatch

def test_async_dispatch_logs_and_trains_as_depth_0(runs, tmp_path):
    """The translation run with ``--async-dispatch 2`` and 0, the port's
    CLI, a fresh start to 6 updates: the same json lines (timing meters
    aside), the same parameters bit for bit, the same update count."""
    lines, params = {}, {}
    for depth in ("0", "2"):
        with _Lines("chimera_st_tpu_torch.logging.progress_bar") as got:
            out = train.main([runs["data"], "--task", "translation", *RUN, "--log-interval", "2",
                              "--best-checkpoint-metric", "loss", "--async-dispatch", depth,
                              "--save-dir", str(tmp_path / depth), "--device", "cpu"])
        assert out["trainer"].num_updates == 6
        lines[depth] = [{k: v for k, v in line.items() if k not in TIMED} for line in got]
        params[depth] = out["trainer"].model.state_dict()
    assert lines["2"] == lines["0"] and len(lines["0"]) == 3
    for k, v in params["0"].items():
        assert torch.equal(params["2"][k], v), k


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))


def _toy_criterion(model, batch, generator=None, num_updates=None):
    loss = ((batch["x"] * model.w - batch["y"]) ** 2).sum()
    ss = float(batch["x"].shape[0])
    return loss, ss, {"loss": loss, "sample_size": ss, "ntokens": ss, "nsentences": ss}


def _toy_batches(n, poison_at=None):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        x = rng.normal(size=(4,)).astype(np.float32)
        y = (3.0 * x).astype(np.float32)
        if i == poison_at:
            y = np.full_like(y, np.nan)
        out.append({"x": x, "y": y})
    return out


def _toy_trainer(depth, schedule=None):
    model = _Toy()
    return Trainer(model, _toy_criterion, build_optimizer({"_name": "adam"}, model.parameters()),
                   build_lr_schedule(schedule or {"_name": "fixed", "lr": 1e-2}),
                   compute_dtype=torch.float32, async_depth=depth)


@pytest.mark.parametrize("poison_at,schedule,seeded", [
    (None, None, True), (2, None, True),
    (2, {"_name": "inverse_sqrt", "lr": 1e-2, "warmup_updates": 3}, False)])
def test_async_trainer_replays_in_order_and_reconciles_the_count(poison_at, schedule, seeded,
                                                                 caplog):
    """The JAX trainer's contract (``tests/test_async_dispatch.py``): with
    ``async_depth`` 8 nothing is read until a drain, the mirror counts
    every dispatch, the drain replays the metrics in order, names the
    skipped update's bad gradients and reconciles the count; the parameter
    equals depth 0's bit for bit, also where the schedule changes with the
    count behind a skipped update (the lr comes from the exact count on the
    device) and the step keys its own seed; at most ``depth`` updates wait
    unread."""
    from chimera_st_tpu_torch.logging import metrics as metrics_mod

    got = {}
    for depth in (0, 8):
        metrics_mod.reset()
        tr = _toy_trainer(depth, schedule)
        with metrics_mod.aggregate("train_inner") as agg, \
                caplog.at_level(logging.WARNING, logger="chimera_st_tpu_torch.train.trainer"):
            for i, b in enumerate(_toy_batches(5, poison_at)):
                assert (tr.train_step([b], seed=i if seeded else None) is None) == (depth > 0)
                assert len(tr._deferred) - tr._waited <= max(depth, 0)
            if depth:
                assert tr.num_updates == 5
            last = tr.drain_metrics()
            smoothed = dict(agg.get_smoothed_values())
        assert (last is None) == (depth == 0)
        got[depth] = (float(tr.model.w.detach()), tr.num_updates, smoothed)
    assert got[8][0] == got[0][0]
    assert got[8][1] == got[0][1] == (4 if poison_at is not None else 5)
    for k in ("loss", "gnorm", "lr"):
        assert got[8][2][k] == pytest.approx(got[0][2][k], nan_ok=True), k
    warnings = [r.getMessage() for r in caplog.records if "non-finite" in r.getMessage()]
    assert len(warnings) == (2 if poison_at is not None else 0)
    assert all("update 2;" in w and "['w']" in w for w in warnings)


# ------------------------------------------------- comma-joined training splits

def test_comma_joined_splits_resample_as_jax(tmp_path):
    """``train_a,train_b`` with ``sampling_alpha`` 0.5: the same ratios,
    sizes, batches and arrays as the JAX task over three epochs (the
    resampled draw changes with the epoch)."""
    from chimera_st_tpu.data.manifests import resample_sizes as jax_resample_sizes
    from chimera_st_tpu_torch.data.manifests import resample_sizes

    root = Path(make_triplet_dir(str(tmp_path), n=8, seed=5))
    rows = (root / "train.tsv").read_text().splitlines()
    (root / "train_a.tsv").write_text("\n".join(rows[:7]) + "\n")
    (root / "train_b.tsv").write_text("\n".join(rows[:1] + rows[7:]) + "\n")
    with open(root / "config_wave.yaml", "a") as f:
        f.write("sampling_alpha: 0.5\n")
    np.testing.assert_allclose(resample_sizes([6, 2], 0.5), jax_resample_sizes([6, 2], 0.5),
                               rtol=1e-15)
    cfg = {"_name": "triplet", "data": str(root), "config_yaml": "config_wave.yaml"}
    tasks = (setup_task(dict(cfg)), jax_setup_task(dict(cfg)))
    datasets = [t.dataset("train_a,train_b") for t in tasks]
    assert len(datasets[0]) == len(datasets[1]) > 0
    itrs = [t.make_batch_iterator(d, max_sentences=2, seed=2)
            for t, d in zip(tasks, datasets)]
    draws = []
    for epoch in (1, 2, 3):
        got, want = (list(itr.next_epoch_itr(shuffle=True)) for itr in itrs)
        assert len(got) == len(want) > 2
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        draws.append([d._cur_indices.tolist() for d in datasets[0].datasets])
        for itr in itrs:
            itr.next_epoch()
    assert draws[0] != draws[1] or draws[1] != draws[2]


# ------------------------------------------------------- validate: features

def test_dump_feature_to_file_writes_the_jax_arrays(tmp_path, capsys):
    """``validate --dump-feature-to-file`` on the triplet task, fp32, from a
    native checkpoint of seeded weights: a batch's audio and text memory
    banks and ids as the JAX CLI pickles them (1e-5 of each array's
    largest value), and the same loss line."""
    from chimera_st_tpu_torch.models.interlingua import init_params_

    data = make_triplet_dir(str(tmp_path / "data"), n=6, seed=4)
    task = setup_task({"_name": "triplet", "data": data, "config_yaml": "config_wave.yaml"})
    model_cfg = {"arch": "s2t_transformer_w2v2_interlingua_base"}
    for key, value in zip(TINY_ARCH_FLAGS[::2], TINY_ARCH_FLAGS[1::2]):
        model_cfg[key[2:].replace("-", "_")] = ast.literal_eval(value)
    model = task.build_model(model_cfg, device="cpu", train=True)
    init_params_(model, torch.Generator().manual_seed(3))
    with open(tmp_path / "seeded.ckpt", "wb") as f:
        pickle.dump({"step": 0, "params": params_to_flax(model.state_dict()), "opt_state": None,
                     "extra": {"model_cfg": model_cfg}}, f)
    argv = [data, "--task", "triplet", "--path", str(tmp_path / "seeded.ckpt"),
            "--valid-subset", "valid", "--criterion", "triplet_st_mt_contrastive",
            "--batch-size", "4", "--num-length-buckets", "2", "--dtype", "float32"]
    jax_validate.main([*argv, "--dump-feature-to-file", str(tmp_path / "jax.pkl")])
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    validate.main([*argv, "--dump-feature-to-file", str(tmp_path / "port.pkl"),
                   "--device", "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    got, want = _load(tmp_path / "port.pkl"), _load(tmp_path / "jax.pkl")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["audio_memory", "id", "text_memory"]
        np.testing.assert_array_equal(g["id"], w["id"])
        for key in ("audio_memory", "text_memory"):
            b = np.asarray(w[key], np.float32)
            assert g[key].shape == b.shape and g[key].dtype == np.float32
            np.testing.assert_allclose(g[key], b, rtol=0, atol=1e-5 * float(np.abs(b).max()),
                                       err_msg=key)
    for (kg, vg), (kw, vw) in zip((p.split(" ") for p in got_line.split(" | ")),
                                  (p.split(" ") for p in want_line.split(" | "))):
        assert kg == kw and abs(float(vg) - float(vw)) <= 1e-4 * max(1.0, abs(float(vw)))
