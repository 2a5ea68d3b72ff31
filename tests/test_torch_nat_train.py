"""Training the non-autoregressive models in the port against the JAX
package on the CPU: the edit operations (the compiled routine against its
numpy version and the JAX package's ``suggested_edit_ops``), the noised
batches of ``translation_lev`` under each ``--noise`` and of
``translation_ins`` array for array over two epochs, and ``cli.train --task
translation_lev`` end to end in both packages (the logged lines, and the
checkpoint resumed across the packages both ways); the criterions' updates
are ``tests/test_torch_nat_updates.py``'s.

Data: ``make_parallel_text`` binarized with a joined dictionary (20
symbols). Widths: 2 + 2 layers, 32 wide, 4 heads, every dropout 0.
Tolerances are ``tests/test_torch_family_train.py``'s (fp32): parameters
1e-4 of the learning rate plus two fp32 roundings (2^-22 relative); losses,
gnorm and logged scalars 1e-5 relative; batches and edit operations
identical.
"""

import logging
import shutil

import jax
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import load_state as jax_load_state
from chimera_st_tpu.clib import suggested_edit_ops as jax_edit_ops
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.cli import preprocess, train
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.data import edit_ops
from chimera_st_tpu_torch.tasks import setup_task
from tests.synthetic_data import make_parallel_text
from tests.test_torch_models import numpy_tree
from tests.test_torch_mt import TIMED, _Lines, _load, jax_serialized

LR = 1e-3
OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": LR, "warmup_updates": 2}
WIDTHS = dict(encoder_embed_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=4,
              decoder_embed_dim=32, decoder_ffn_dim=64, decoder_layers=2, decoder_heads=4)
CLI = ["--task", "translation_lev", "-s", "de", "-t", "en", "--noise", "levenshtein",
       "--arch", "levenshtein_transformer", "--max-ins", "8", "--criterion",
       "levenshtein_loss", "--label-smoothing", "0.1", "--batch-size", "8",
       "--dropout", "0", "--attention-dropout", "0", "--activation-dropout", "0",
       "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-3", "--lr", str(LR),
       "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--max-update", "4",
       "--save-interval-updates", "2", "--dtype", "float32", "--log-format", "json",
       "--log-interval", "1", "--num-length-buckets", "2",
       *[x for k, v in WIDTHS.items() for x in (f"--{k.replace('_', '-')}", str(v))]]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    work = tmp_path_factory.mktemp("nat_train")
    raw = make_parallel_text(str(work / "raw"))
    preprocess.main(["-s", "de", "-t", "en", "--trainpref", f"{raw}/train", "--validpref",
                     f"{raw}/valid", "--destdir", str(work / "bin"), "--joined-dictionary"])
    return work


def _tasks(data, name, noise):
    cfg = {"_name": name, "data": str(data / "bin"), "source_lang": "de", "target_lang": "en",
           "noise": noise}
    task, jax_task = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    for t in (task, jax_task):
        t.load_dataset("train")
    return task, jax_task


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_ops_match_numpy_and_jax(seed):
    """Seeded pairs with empty, equal and fully padded rows: the compiled
    routine, its numpy version and the JAX package's, identical."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(2, 9, size=(12, 14)).astype(np.int32)
    ys = rng.integers(2, 9, size=(12, 11)).astype(np.int32)
    xs[:, -3:] = ys[:, -2:] = 1  # pads at the right
    xs[0] = 1  # an empty input
    ys[1] = 1  # an empty output
    ys[2, :8] = xs[2, :8]
    xs[2, 8:] = ys[2, 8:] = 1  # equal rows
    xs[3, 4:7] = 1  # pads inside a row
    got = edit_ops.suggested_edit_ops(xs, ys, 1)
    for other in (edit_ops.suggested_edit_ops_plain(xs, ys, 1), jax_edit_ops(xs, ys, 1)):
        for g, w in zip(got, other):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert not got[0][2].any() and not got[2][2].any()  # equal rows: nothing to edit
    assert got[1][0][:int((ys[0] != 1).sum())].all()  # empty input: all insertions


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source g++ cannot compile raises."""
    bad = tmp_path / "edit_ops.cpp"
    bad.write_text("not C++\n")
    monkeypatch.setattr(edit_ops, "SOURCE", bad)
    monkeypatch.setattr(edit_ops, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        edit_ops.build()


@pytest.mark.parametrize("name, noise", [("translation_lev", "levenshtein"),
                                         ("translation_lev", "random_mask"),
                                         ("translation_lev", "full_mask"),
                                         ("translation_ins", "levenshtein")])
def test_noised_batches_match_jax_over_two_epochs(data, name, noise):
    """Every batch of two epochs (the iterator's order and padding, the
    noise of (seed, epoch, sample id)) array for array against JAX's; the
    levenshtein and random-mask noises re-roll in epoch 2, the insertion
    task's does not (its collate takes no epoch, in JAX as here: ROADMAP
    C), and the full mask draws nothing."""
    task, jax_task = _tasks(data, name, noise)
    its = [t.make_batch_iterator(t.dataset("train"), max_sentences=8, seed=3,
                                 num_length_buckets=2) for t in (task, jax_task)]
    epochs = []
    for epoch in (1, 2):
        batches = [list(it.next_epoch_itr(shuffle=False)) for it in its]
        for it in its:
            it.next_epoch()
        assert len(batches[0]) == len(batches[1]) == 4
        for got, want in zip(*batches):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                              err_msg=f"epoch {epoch}: {k}")
        epochs.append(batches[0])
    key = "masked_target" if noise != "levenshtein" else "ins_input"
    rerolled = any(not np.array_equal(a[key], b[key]) for a, b in zip(*epochs))
    assert rerolled == (name == "translation_lev" and noise != "full_mask")


@pytest.fixture(scope="module")
def runs(data):
    """The JAX CLI run 0 -> 4 (a save every 2 updates) and the port's
    resume of its update-2 checkpoint to 4, with their json lines."""
    argv = [str(data / "bin"), *CLI, "--disable-validation"]
    jax_dir, port_dir = data / "jax_run", data / "port_run"
    with _Lines("chimera_st_tpu.logging.progress_bar") as jax_lines:
        jax_train.main(argv + ["--save-dir", str(jax_dir)])
    port_dir.mkdir()
    shutil.copy(jax_dir / "checkpoint_1_2.ckpt", port_dir / "checkpoint_1_2.ckpt")
    with _Lines("chimera_st_tpu_torch.logging.progress_bar") as port_lines:
        out = train.main(argv + ["--save-dir", str(port_dir), "--restore-file",
                                 "checkpoint_1_2.ckpt", "--device", "cpu"])
    return dict(jax_dir=jax_dir, port_dir=port_dir, jax_lines=jax_lines,
                port_lines=port_lines, out=out)


def test_cli_resumes_a_jax_run_to_its_lines_and_parameters(runs):
    """The port's lines for updates 3 and 4 are JAX's; its update-4
    parameters are the uninterrupted JAX run's."""
    jax_lines = {line["update"]: line for line in runs["jax_lines"]}
    assert [line["update"] for line in runs["port_lines"]] == [0.75, 1.0]  # of epoch 1
    for line in runs["port_lines"]:
        want = jax_lines[line["update"]]
        assert set(line) == set(want)
        for key, value in line.items():
            # a meter another run in the process left (logged "None") equals JAX's too
            if key in TIMED or value == want[key]:
                continue
            np.testing.assert_allclose(float(value), float(want[key]), rtol=1e-5,
                                       err_msg=f"update {line['update']}: {key}")
    want, got = (_load(d / "checkpoint_last.ckpt") for d in (runs["jax_dir"], runs["port_dir"]))
    assert got["step"] == want["step"] == 4
    assert got["extra"]["train_iterator"] == want["extra"]["train_iterator"]
    w = params_from_flax(want["params"], "levenshtein_transformer")
    g = params_from_flax(got["params"], "levenshtein_transformer")
    for k in w:
        np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), atol=1e-4 * LR, rtol=2.0 ** -22,
                                   err_msg=k)


def test_port_checkpoint_restores_in_jax(runs, caplog):
    """The port's ``checkpoint_last.ckpt`` through the JAX ``load_state``
    into the JAX CLI's template: no optimizer-reset warning, the step, the
    parameters and the Adam moments exactly."""
    path = runs["port_dir"] / "checkpoint_last.ckpt"
    extra = _load(path)["extra"]
    task = jax_setup_task(dict(extra["task_cfg"]))
    model = task.build_model(dict(extra["model_cfg"]))

    class _Args:
        seed = 1
        w2v2_model_path = None

    template = jax_train.init_params_for_task(model, task, _Args())
    tx = jax_build_optimizer(OPT_CFG, jax_build_lr_schedule(SCHED_CFG))
    with caplog.at_level(logging.WARNING):
        state, _ = jax_load_state(str(path), create_train_state(template, tx))
    assert not [rec for rec in caplog.records if "optimizer state" in rec.getMessage()]
    assert int(state.step) == 4
    trainer = runs["out"]["trainer"]
    held = trainer.model.state_dict()
    for k, v in params_from_flax(numpy_tree(state.params), "levenshtein_transformer").items():
        assert torch.equal(v, held[k]), k
    saved = jax.tree_util.tree_map(np.asarray, jax_serialized(state.opt_state))
    restored, count, _ = trainer.optimizer.read_optax(saved, trainer.model)
    assert count == 4
    for name, p in trainer.model.named_parameters():
        assert torch.equal(restored["mu"][name], trainer.optimizer.optimizer.state[p]["exp_avg"])


def test_seed_never_reaches_the_noise_in_either_package(runs):
    """Both train CLIs build the task from the undeclared flags, where
    ``--seed`` is not: the task config they store holds no seed, so the
    noise is keyed by the task's default seed 1 (ROADMAP C)."""
    for d in (runs["jax_dir"], runs["port_dir"]):
        task_cfg = _load(d / "checkpoint_last.ckpt")["extra"]["task_cfg"]
        assert "seed" not in task_cfg and task_cfg["noise"] == "levenshtein"
        assert setup_task(dict(task_cfg)).seed == jax_setup_task(dict(task_cfg)).seed == 1


def test_unknown_noise_raises_as_jax(data):
    cfg = {"_name": "translation_lev", "data": str(data / "bin"), "source_lang": "de",
           "target_lang": "en", "noise": "random_delete"}
    with pytest.raises(ValueError, match="unknown --noise") as want:
        jax_setup_task(dict(cfg))
    with pytest.raises(ValueError) as got:
        setup_task(dict(cfg))
    assert str(got.value) == str(want.value)
