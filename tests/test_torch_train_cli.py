"""The port's train and validate CLIs against the JAX package's train CLI on
the CPU (``--device cpu``, fp32).

A module fixture runs the JAX ``cli.train.main`` once on ``make_triplet_dir``
(8 rows): the tiny architecture, every dropout 0, the triplet criterion,
Adam (0.9, 0.98) with eps 1e-3, ``inverse_sqrt`` lr 1e-3 over 2 warm-up
updates, batches of 4 (2 updates an epoch), 5 updates, a save every 3
updates, so that ``checkpoint_2_3.ckpt`` falls in the middle of epoch 2.
The port's train CLI then resumes a copy of that checkpoint to update 5.

Tolerances (fp32; the rules of ``tests/test_torch_train.py``):

- parameters: 1e-4 of the learning rate plus two fp32 roundings (2^-22
  relative): Adam with eps 1e-3 turns a gradient difference d into an
  update difference of at most lr * d / eps;
- Adam's moments: 1e-4 of each tensor's largest value (the gradients agree
  to 1e-5 of their largest; the second moment squares them; a key
  projection's bias, whose exact gradient is 0, against its weight's);
- logged scalars, the best metric, the validation loss: 1e-5 relative
  (the log rounds to three decimals, so the printed values are equal).
"""

import json
import logging
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu_torch.cli import train, validate
from chimera_st_tpu_torch.convert import params_from_flax
from tests.synthetic_data import TINY_ARCH_FLAGS, make_triplet_dir
from tests.test_torch_mt import _Lines

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
NO_DROPOUT = ["--dropout", "0", "--attention-dropout", "0", "--activation-dropout", "0",
              "--w2v2-dropout", "0", "--w2v2-attention-dropout", "0",
              "--w2v2-activation-dropout", "0"]
RUN = [*TINY_ARCH_FLAGS, "--criterion", "triplet_st_mt_contrastive", "--label-smoothing", "0.1",
       "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-3", "--lr", str(LR),
       "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
       "--batch-size", "4", "--update-freq", "1", "--max-update", "5",
       "--save-interval-updates", "3", "--dtype", "float32", "--num-length-buckets", "2",
       "--best-checkpoint-metric", "st_loss", "--log-format", "json", "--log-interval", "1"]
# timing meters: the one thing two runs cannot share
TIMED = {"ups", "wps"}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run 0 -> 5 and the port's resume of its update-3 checkpoint
    -> 5, with the json progress lines of both."""
    work = tmp_path_factory.mktemp("train_cli")
    data = make_triplet_dir(str(work / "data"))
    jax_dir, port_dir = work / "jax", work / "port"
    with _Lines("chimera_st_tpu.logging.progress_bar") as jax_lines:
        jax_train.main([data, "--task", "triplet", *RUN, *NO_DROPOUT, "--save-dir", str(jax_dir)])
    port_dir.mkdir()
    shutil.copy(jax_dir / "checkpoint_2_3.ckpt", port_dir / "checkpoint_2_3.ckpt")
    with _Lines("chimera_st_tpu_torch.logging.progress_bar") as port_lines:
        out = train.main([data, "--task", "triplet", *RUN, *NO_DROPOUT,
                          "--save-dir", str(port_dir), "--restore-file", "checkpoint_2_3.ckpt",
                          "--device", "cpu"])
    return dict(data=data, jax_dir=jax_dir, port_dir=port_dir, jax_lines=jax_lines,
                port_lines=port_lines, out=out)


def test_jax_checkpoint_at_update_3_is_mid_epoch(runs):
    extra = _load(runs["jax_dir"] / "checkpoint_2_3.ckpt")["extra"]
    assert extra["train_iterator"] == {"epoch": 2, "iterations_in_epoch": 1, "shuffle": True}
    assert runs["out"]["times"]["restored"]["step"] == 3
    assert runs["out"]["times"]["restored"]["train_iterator"]["iterations_in_epoch"] == 1


def test_resumed_parameters_match_jax(runs):
    want = params_from_flax(_load(runs["jax_dir"] / "checkpoint_last.ckpt")["params"])
    got_payload = _load(runs["port_dir"] / "checkpoint_last.ckpt")
    got = params_from_flax(got_payload["params"])
    assert set(got) == set(want)
    held = runs["out"]["trainer"].model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-4 * LR, rtol=2.0 ** -22,
                                   err_msg=k)
        assert torch.equal(got[k], held[k]), k  # written equals held


def test_resumed_adam_state_matches_jax(runs):
    want, got = (_load(d / "checkpoint_last.ckpt")["opt_state"]
                 for d in (runs["jax_dir"], runs["port_dir"]))
    trainer = runs["out"]["trainer"]
    (w_state, w_count, w_sched), (g_state, g_count, g_sched) = (
        trainer.optimizer.read_optax(t, trainer.model) for t in (want, got))
    assert w_count == g_count == w_sched == g_sched == 5
    names = {n for n, _ in trainer.model.named_parameters()}
    for key in ("mu", "nu"):
        assert set(w_state[key]) == set(g_state[key]) == names
        for name, w in w_state[key].items():
            # a key projection's bias has an exact gradient of 0 (a softmax
            # row shifted by a constant): its moments are round-off, held
            # against its weight's
            scale = w_state[key][name[:-4] + "weight"] if name.endswith("k_proj.bias") else w
            tol = 1e-4 * float(scale.abs().max()) + 1e-30
            np.testing.assert_allclose(g_state[key][name].numpy(), w.numpy(), atol=tol, rtol=0,
                                       err_msg=f"{name} {key}")


def test_resumed_step_iterator_best_and_configs_match_jax(runs):
    want, got = (_load(d / "checkpoint_last.ckpt") for d in (runs["jax_dir"], runs["port_dir"]))
    assert got["step"] == want["step"] == 5
    assert got["format_version"] == want["format_version"] == 1
    assert got["extra"]["train_iterator"] == want["extra"]["train_iterator"]
    np.testing.assert_allclose(got["extra"]["best"], want["extra"]["best"], rtol=1e-5)
    for key in ("model_cfg", "task_cfg", "criterion_cfg"):
        assert got["extra"][key] == want["extra"][key], key
    # the same file set: interval and end-of-epoch saves, best and last
    jax_names = {p.name for p in runs["jax_dir"].glob("*.ckpt")}
    port_names = {p.name for p in runs["port_dir"].glob("*.ckpt")}
    assert port_names == jax_names - {"checkpoint1.ckpt"}


def test_logged_training_lines_match_jax(runs):
    """The port logs updates 4 and 5; JAX's lines for the same updates."""
    jax_lines = {line["update"]: line for line in runs["jax_lines"]}
    assert len(runs["port_lines"]) == 2
    for line in runs["port_lines"]:
        want = jax_lines[line["update"]]
        assert set(line) == set(want)
        for key, value in line.items():
            if key in TIMED:
                continue
            np.testing.assert_allclose(float(value), float(want[key]), rtol=1e-5,
                                       err_msg=f"update {line['update']}: {key}")


def test_validate_cli_matches_jax_val_loss(runs, capsys):
    ckpt = runs["jax_dir"] / "checkpoint_2_3.ckpt"
    stats = validate.main([runs["data"], "--task", "triplet", "--path", str(ckpt),
                           "--valid-subset", "valid", "--criterion", "triplet_st_mt_contrastive",
                           "--label-smoothing", "0.1", "--batch-size", "4",
                           "--num-length-buckets", "2", "--dtype", "float32", "--device", "cpu"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith("contrastive_loss ") and "| st_loss " in printed
    np.testing.assert_allclose(stats["st_loss"], _load(ckpt)["extra"]["val_loss"], rtol=1e-5)


def test_port_checkpoint_restores_in_jax_without_reset(runs, caplog):
    """The port's ``checkpoint_last.ckpt`` through the JAX ``load_state``
    into a ``create_train_state`` template: no optimizer-reset warning, and
    the restored moments are the port's exactly."""
    from chimera_st_tpu.checkpoint.store import load_state
    from chimera_st_tpu.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu.tasks import setup_task
    from chimera_st_tpu.train.train_step import create_train_state

    path = runs["port_dir"] / "checkpoint_last.ckpt"
    extra = _load(path)["extra"]
    task = setup_task(dict(extra["task_cfg"]))
    model = task.build_model(dict(extra["model_cfg"]))

    class _Args:
        seed = 1
        w2v2_model_path = None

    template_params = jax_train.init_params_for_task(model, task, _Args())
    tx = build_optimizer({"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3},
                         build_lr_schedule({"_name": "inverse_sqrt", "lr": LR,
                                            "warmup_updates": 2}))
    with caplog.at_level(logging.WARNING):
        state, _ = load_state(str(path), create_train_state(template_params, tx))
    assert not [r for r in caplog.records if "optimizer state" in r.getMessage()]
    assert int(state.step) == 5
    trainer = runs["out"]["trainer"]
    named = dict(trainer.model.named_parameters())
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, state.opt_state[0].mu))
    nu = params_from_flax(jax.tree_util.tree_map(np.asarray, state.opt_state[0].nu))
    assert int(state.opt_state[0].count) == int(state.opt_state[1].count) == 5
    for name, p in named.items():
        s = trainer.optimizer.optimizer.state[p]
        assert torch.equal(mu[name], s["exp_avg"]) and torch.equal(nu[name], s["exp_avg_sq"])


def _port_train(data, save_dir, *extra):
    """The port's train CLI in a process of its own, default dropouts."""
    cmd = [sys.executable, "-m", "chimera_st_tpu_torch.cli.train", data, "--task", "triplet",
           *RUN, "--save-dir", str(save_dir), "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_resumed_run_equals_uninterrupted_run_with_dropout(runs, tmp_path):
    """Dropout at its defaults: 0 -> 5 in one process equals 0 -> 3, saved,
    then 3 -> 5 resumed in a fresh process, parameter for parameter."""
    data = runs["data"]
    whole, split = tmp_path / "whole", tmp_path / "split"
    _port_train(data, whole)
    _port_train(data, split, "--max-update", "3")
    _port_train(data, split, "--restore-file", "checkpoint_2_3.ckpt")
    a, b = (_load(d / "checkpoint_last.ckpt") for d in (whole, split))
    assert a["step"] == b["step"] == 5
    pa, pb = params_from_flax(a["params"]), params_from_flax(b["params"])
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


UNPORTED_TRAIN_FLAGS = {
    "arch": ["--arch", "s2t_transformer_s"],
    "task": ["--task", "speech_to_text"],
    "zero_sharding": ["--zero-sharding", "os"],
    "pipeline_stages": ["--pipeline-stages", "2"],
    "distributed_world_size": ["--distributed-world-size", "2"],
    "distributed_init_method": ["--distributed-init-method", "tcp://localhost:1"],
    "model_parallel_size": ["--model-parallel-size", "2"],
}


# the A12 flags that once raised, now run (the grid they make in a world of 2)
A12_GRIDS = {"model_parallel_size": {"data": 1, "model": 2},
             "pipeline_stages": {"data": 1, "pipe": 2},
             "zero_sharding": {"data": 2, "model": 1}}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The train CLI's grid for each A12 flag, made by a gloo world of 2 on
    this host (``tests/torch_parallel_worker.py``)."""
    from tests import torch_parallel_worker as worker

    work = tmp_path_factory.mktemp("grids")
    names = sorted(A12_GRIDS)
    torch.multiprocessing.start_processes(
        worker.grid_rank, args=(str(work), [UNPORTED_TRAIN_FLAGS[n] for n in names]),
        nprocs=2, join=True, start_method="spawn")
    return dict(zip(names, pickle.loads((work / "grids.pkl").read_bytes())))


@pytest.mark.parametrize("name", sorted(UNPORTED_TRAIN_FLAGS))
def test_unported_train_option_raises(name, tmp_path, request, monkeypatch):
    """The rows of ``options.TRAIN_UNPORTED`` (fbank training, A10c) raise
    naming their item. The A12 flags, once refused, now run:
    ``--distributed-world-size 2`` starts two ranks (recorded here; the
    ranks train in ``tests/test_torch_parallel.py``), an init method joins
    this process as rank 0 of 1, and the grid flags make their grids over
    a world of 2."""
    from chimera_st_tpu_torch.cli import options
    from chimera_st_tpu_torch.parallel import mesh as mesh_mod

    assert {attr for attr, *_ in options.TRAIN_UNPORTED} == {"arch", "task"}
    flags = UNPORTED_TRAIN_FLAGS[name]
    if name in ("arch", "task"):
        with pytest.raises(NotImplementedError, match=r"ROADMAP A1\d"):
            train.main([str(tmp_path), "--device", "cpu", *flags])
    elif name == "distributed_world_size":
        started = []
        monkeypatch.setattr(mesh_mod, "spawn", lambda fn, n, *a, **k: started.append((n, k)))
        assert train.main([str(tmp_path), "--device", "cpu", *flags]) is None
        assert started == [(2, {"device": "cpu"})]
    elif name == "distributed_init_method":
        p = options.base_parser("train")
        options.add_train_args(p)
        with pytest.raises(SystemExit, match="--distributed-rank"):
            options.setup_mesh(options.parse_with_model_overrides(
                p, [str(tmp_path), "--cpu", *flags])[0], "cpu")
        args, _ = options.parse_with_model_overrides(p, [
            str(tmp_path), "--cpu", "--distributed-init-method",
            f"file://{tmp_path}/rendezvous", "--distributed-rank", "0",
            "--distributed-num-procs", "1"])
        try:
            assert options.setup_mesh(args, "cpu").shape == {"data": 1, "model": 1}
        finally:
            torch.distributed.destroy_process_group()
    else:
        assert request.getfixturevalue("grids")[name] == A12_GRIDS[name]


def test_profile_writes_a_trace(runs, tmp_path):
    """``--profile DIR``: a torch.profiler trace of the run."""
    train.main([runs["data"], "--task", "triplet", *RUN, "--max-update", "1",
                "--save-dir", str(tmp_path / "ckpt"), "--device", "cpu",
                "--profile", str(tmp_path / "trace"), "--no-save"])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("main", [train.main, validate.main])
def test_card_is_the_default_device(main, tmp_path):
    """Without ``--device cpu`` / ``--cpu`` the entry points ask for the
    card and raise without one; nothing falls back to the CPU."""
    argv = [str(tmp_path)] + (["--path", "x.ckpt"] if main is validate.main else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_bleu_validation_drives_best(runs, tmp_path):
    """``--best-checkpoint-metric bleu --maximize-best-checkpoint-metric``:
    validation decodes the valid split (beam 4, as the JAX CLI) and the
    corpus BLEU is the best metric saved."""
    out = train.main([runs["data"], "--task", "triplet", *RUN, "--max-update", "1",
                      "--save-dir", str(tmp_path), "--device", "cpu",
                      "--best-checkpoint-metric", "bleu",
                      "--maximize-best-checkpoint-metric"])
    (val,) = out["times"]["valid"]
    assert 0.0 <= val <= 100.0
    assert _load(tmp_path / "checkpoint_best.ckpt")["extra"]["best"] == val
