"""The port's joint MT + ST training (``--task joint_task_mtst
--task-configs st.json mt.json --main-task st``) against the JAX package on
the CPU: the epoch schedule, the interleaved batches, and the train CLI.

A module fixture builds ST triplets (``make_triplet_dir``, 8 rows: 2
batches of 4) and 16 MT pairs binarized on the same dictionary (4 batches
at ratio 0.5: 2 an epoch), so that an epoch is 4 micro-batches, 2 updates
of ``--update-freq 2``, and writes the sub-task configs as JSON. It runs
the JAX train CLI 0 -> 4 updates (the tiny architecture, every dropout 0,
Adam with eps 1e-3); the port's train CLI resumes JAX's end-of-epoch-1
checkpoint to update 4, whose updates mix ST and MT micro-batches.

Tolerances (fp32; the rules of ``tests/test_torch_train_cli.py``): the
logged scalars and the validation loss 1e-5 relative, the parameters 1e-4
of the learning rate plus two fp32 roundings."""

import json
import logging
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import load_state as jax_load_state
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.data.joint_dataset import JointBatchSchedule as JaxSchedule
from chimera_st_tpu.logging import metrics as jax_metrics
from chimera_st_tpu.optim import build_lr_schedule as jax_schedule
from chimera_st_tpu.optim import build_optimizer as jax_optimizer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.cli import preprocess, train
from chimera_st_tpu_torch.config.registry import CRITERIONS, MODELS
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.data.joint_dataset import JointBatchSchedule
from chimera_st_tpu_torch.logging import metrics
from chimera_st_tpu_torch.tasks import setup_task
from tests.synthetic_data import TINY_ARCH_FLAGS, make_parallel_text, make_triplet_dir
from tests.test_torch_train_cli import NO_DROPOUT, TIMED, _Lines

LR = 1e-3
SEED = 3  # both epochs mix an ST and an MT micro-batch in each update


def _configs(st_dir, bin_dir, mt_ratio=0.5):
    return [
        {"task_name": "st", "sample_ratio": 1.0, "weight": 1.0,
         "task": {"_name": "triplet", "data": st_dir},
         "criterion": {"_name": "triplet_st_mt_contrastive", "label_smoothing": 0.1,
                       "loss_ratio": [1.0, 1.0, 1.0]}},
        {"task_name": "mt", "sample_ratio": mt_ratio, "weight": 0.5,
         "task": {"_name": "translation", "data": bin_dir, "source_lang": "de",
                  "target_lang": "en"},
         "criterion": {"_name": "label_smoothed_cross_entropy", "label_smoothing": 0.1}},
    ]


def _argv(data, configs, save_dir, max_update, *extra):
    return [data, "--task", "joint_task_mtst", "--task-configs", *configs, "--main-task", "st",
            *TINY_ARCH_FLAGS, *NO_DROPOUT, "--criterion", "label_smoothed_cross_entropy",
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-3",
            "--lr", str(LR), "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2",
            "--batch-size", "4", "--update-freq", "2", "--max-update", str(max_update),
            "--dtype", "float32", "--num-length-buckets", "2", "--seed", str(SEED),
            "--log-format", "json", "--log-interval", "1", "--save-dir", str(save_dir), *extra]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", autouse=True)
def _fresh_meters():
    """Both train CLIs keep their meters in a process-global stack: the
    joint runs start from none and leave none for a later test's logged
    lines."""
    jax_metrics.reset()
    metrics.reset()
    yield
    jax_metrics.reset()
    metrics.reset()


@pytest.fixture(scope="module")
def joint(tmp_path_factory):
    work = tmp_path_factory.mktemp("joint")
    st_dir = make_triplet_dir(str(work / "st"))
    raw = make_parallel_text(str(work / "raw"), n=16)
    bin_dir = str(work / "bin")
    preprocess.main(["-s", "de", "-t", "en", "--trainpref", f"{raw}/train", "--validpref",
                     f"{raw}/valid", "--destdir", bin_dir, "--srcdict", f"{st_dir}/dict.txt",
                     "--tgtdict", f"{st_dir}/dict.txt"])
    configs = []
    for cfg in _configs(st_dir, bin_dir):
        path = work / f"{cfg['task_name']}.json"
        path.write_text(json.dumps(cfg))
        configs.append(str(path))
    jax_dir, port_dir = work / "jax", work / "port"
    with _Lines("chimera_st_tpu.logging.progress_bar") as jax_lines:
        jax_train.main(_argv(st_dir, configs, jax_dir, 4))
    port_dir.mkdir()
    shutil.copy(jax_dir / "checkpoint1.ckpt", port_dir / "checkpoint1.ckpt")
    with _Lines("chimera_st_tpu_torch.logging.progress_bar") as port_lines:
        out = train.main(_argv(st_dir, configs, port_dir, 4, "--restore-file",
                               "checkpoint1.ckpt", "--device", "cpu"))
    return dict(work=work, st_dir=st_dir, bin_dir=bin_dir, configs=configs, jax_dir=jax_dir,
                port_dir=port_dir, jax_lines=jax_lines, port_lines=port_lines, out=out)


@pytest.mark.parametrize("seed, epoch, ratios", [
    (1, 1, {"a": 1.0, "b": 0.5}), (1, 2, {"a": 1.0, "b": 0.5}), (7, 3, {"a": 0.3, "b": 2.5}),
    (2, 1, {"a": 1.0, "b": 1.0, "c": 0.25})])
def test_epoch_schedule_matches_jax(seed, epoch, ratios):
    batches = {name: [np.arange(i, i + 2) for i in range(n)]
               for name, n in zip(ratios, (7, 12, 5))}
    want = JaxSchedule(batches, ratios, seed=seed).epoch_schedule(epoch)
    got = JointBatchSchedule(batches, ratios, seed=seed).epoch_schedule(epoch)
    assert got == want and got


def test_joint_batches_match_jax(joint):
    """The interleaved batches of two epochs, array for array, with their
    ``task_name``."""
    configs = {"_name": "joint_task_mtst", "main_task": "st", "task_configs": joint["configs"]}
    port, ref = setup_task(dict(configs)), jax_setup_task(dict(configs))
    for t in (port, ref):
        t.load_dataset("train")
    for epoch in (1, 2):
        kw = dict(max_sentences=4, seed=SEED, num_length_buckets=2, epoch=epoch)
        got = list(port.make_joint_iterator("train", **kw))
        want = list(ref.make_joint_iterator("train", **kw))
        assert [b["task_name"] for b in got] == [b["task_name"] for b in want]
        assert sorted(b["task_name"] for b in got) == ["mt", "mt", "st", "st"]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(g[k], v, err_msg=k)
                else:
                    assert g[k] == v, k


def test_resumed_updates_mix_tasks_and_match_jax(joint):
    """Updates 3 and 4 (epoch 2) from JAX's end-of-epoch-1 checkpoint: the
    logged lines (the union of the ST and MT keys) and every parameter equal
    JAX's; an update holds an ST and an MT micro-batch."""
    configs = {"_name": "joint_task_mtst", "main_task": "st", "task_configs": joint["configs"]}
    task = setup_task(configs)
    task.load_dataset("train")
    names = [b["task_name"] for b in task.make_joint_iterator(
        "train", max_sentences=4, seed=SEED, num_length_buckets=2, epoch=2)]
    assert {names[0], names[1]} == {"st", "mt"}, names
    # one line an update (the streaming iterator's lines carry no update
    # number): JAX's of epoch 2 are its last two
    assert len(joint["jax_lines"]) == 4 and len(joint["port_lines"]) == 2
    for update, (line, want) in enumerate(zip(joint["port_lines"], joint["jax_lines"][2:]), 3):
        assert set(line) == set(want) and line["epoch"] == 2
        assert {"st_loss", "mt_loss", "contrastive_loss", "nll_loss"} <= set(line)
        for key, value in line.items():
            if key not in TIMED:
                np.testing.assert_allclose(float(value), float(want[key]), rtol=1e-5,
                                           err_msg=f"update {update}: {key}")
    want = params_from_flax(_load(joint["jax_dir"] / "checkpoint_last.ckpt")["params"])
    got = _load(joint["port_dir"] / "checkpoint_last.ckpt")
    assert got["step"] == 4
    for k, w in params_from_flax(got["params"]).items():
        np.testing.assert_allclose(w.numpy(), want[k].numpy(), atol=1e-4 * LR, rtol=2.0 ** -22,
                                   err_msg=k)


def test_validation_on_the_main_task_matches_jax(joint):
    """Each run validated over the ST sub-task: the stored validation loss
    and best metric of the end-of-epoch-2 checkpoints agree."""
    want, got = (_load(d / "checkpoint_last.ckpt")["extra"]
                 for d in (joint["jax_dir"], joint["port_dir"]))
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["best"], want["best"], rtol=1e-5)
    assert got["train_iterator"] == want["train_iterator"] == {"epoch": 3}
    assert got["task_cfg"]["task_configs"] == want["task_cfg"]["task_configs"]
    assert joint["out"]["times"]["valid"] and all(np.isfinite(joint["out"]["times"]["valid"]))


def test_port_checkpoint_restores_in_jax_and_back(joint, caplog, tmp_path):
    """The port's ``checkpoint_last.ckpt`` through the JAX ``load_state``
    into the joint model's template: no optimizer reset, the moments the
    port's exactly; and the port's CLI restores it (update count, Adam
    state) to go on to update 5."""
    path = joint["port_dir"] / "checkpoint_last.ckpt"
    extra = _load(path)["extra"]
    task = jax_setup_task(dict(extra["task_cfg"]))
    model = task.build_model(dict(extra["model_cfg"]))

    class _Args:
        seed = 1
        w2v2_model_path = None

    tx = jax_optimizer({"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3},
                       jax_schedule({"_name": "inverse_sqrt", "lr": LR, "warmup_updates": 2}))
    template = create_train_state(jax_train.init_params_for_task(model, task, _Args()), tx)
    with caplog.at_level(logging.WARNING):
        state, _ = jax_load_state(str(path), template)
    assert not [r for r in caplog.records if "optimizer state" in r.getMessage()]
    assert int(state.step) == 4 and int(state.opt_state[0].count) == 4
    trainer = joint["out"]["trainer"]
    mu = params_from_flax(jax.tree_util.tree_map(np.asarray, state.opt_state[0].mu))
    for name, p in trainer.model.named_parameters():
        assert torch.equal(mu[name], trainer.optimizer.optimizer.state[p]["exp_avg"]), name
    again = tmp_path / "again"
    again.mkdir()
    shutil.copy(path, again / "checkpoint_last.ckpt")
    out = train.main(_argv(joint["st_dir"], joint["configs"], again, 5, "--device", "cpu",
                           "--disable-validation"))
    assert out["times"]["restored"]["step"] == 4 and out["trainer"].num_updates == 5
    state5, count, schedule_count = out["trainer"].optimizer.read_optax(
        _load(again / "checkpoint_last.ckpt")["opt_state"], out["trainer"].model)
    assert count == schedule_count == 5 and set(state5) == {"mu", "nu"}


def test_joint_mtst_refuses_unequal_dictionaries(joint, tmp_path):
    other = tmp_path / "dict.txt"
    other.write_text("zzz 1\n" + (joint["work"] / "st" / "dict.txt").read_text())
    bin_dir = tmp_path / "bin"
    shutil.copytree(joint["bin_dir"], bin_dir)
    shutil.copy(other, bin_dir / "dict.en.txt")
    configs = _configs(joint["st_dir"], str(bin_dir))
    with pytest.raises(AssertionError, match="joint target vocabulary"):
        setup_task({"_name": "joint_task_mtst", "task_configs": configs})
    # joint_task itself takes unequal dictionaries
    task = setup_task({"_name": "joint_task", "task_configs": configs, "main_task": "mt"})
    assert task.main_task_name == "mt" and len(task.target_dictionary) == len(
        task.sub_tasks["st"].target_dictionary) + 1


@pytest.mark.parametrize("kind", ["model", "criterion"])
def test_reference_joint_names_raise_the_migration_message(kind):
    import chimera_st_tpu_torch.tasks  # noqa: F401 — registration

    with pytest.raises(SystemExit, match=f"reference's {kind} `joint_"):
        if kind == "model":
            MODELS.get("joint_model")({}, device="cpu")
        else:
            CRITERIONS.get("joint_criterion")({})


def test_joint_task_refuses_shards(joint, tmp_path):
    """A joint task's interleaved batches are not sharded: ``--num-shards``
    above 1 is refused, not ignored."""
    with pytest.raises(SystemExit, match="--num-shards > 1 is not supported for a joint task"):
        train.main(_argv(joint["st_dir"], joint["configs"], tmp_path, 1, "--device", "cpu",
                         "--num-shards", "2", "--shard-id", "1"))
