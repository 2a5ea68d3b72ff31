"""The host parts of the port's trainer against the JAX package's, side by
side on the CPU: the parameter and Adam-state trees of a checkpoint, the
checkpoint manager's files, the epoch iterator's batch order, the meters,
the progress lines and the ``--fix-*`` freezing.

The weights are the TINY interlingua model's, made by a seeded torch
reference and carried into a flax tree by the JAX package's fairseq
importer (numpy only: nothing for XLA to compile). After two updates from
the same gradients the Adam moments agree within 1e-6 of each tensor's
largest value and the parameters within 1e-4 of the learning rate plus two
fp32 roundings (fp32: torch's and optax's Adam round differently)."""

import dataclasses
import io
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from chimera_st_tpu.checkpoint import torch_import as jax_import
from chimera_st_tpu.checkpoint.store import CheckpointManager as JaxManager
from chimera_st_tpu.data.iterators import EpochBatchIterator as JaxIterator
from chimera_st_tpu.data.iterators import GroupedIterator as JaxGrouped
from chimera_st_tpu.logging import meters as jax_meters
from chimera_st_tpu.logging import progress_bar as jax_progress
from chimera_st_tpu.optim import build_lr_schedule as jax_schedule
from chimera_st_tpu.optim import build_optimizer as jax_optimizer
from chimera_st_tpu.optim import freeze as jax_freeze
from chimera_st_tpu_torch.checkpoint.store import CheckpointManager, TrainState
from chimera_st_tpu_torch.convert import params_from_flax, params_to_flax
from chimera_st_tpu_torch.data.iterators import EpochBatchIterator, GroupedIterator
from chimera_st_tpu_torch.logging import meters, progress_bar
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.optim import freeze
from chimera_st_tpu_torch.train import global_norm
from tests.test_interlingua_model import TINY
from tests.test_torch_checkpoint import fairseq_state_dict
from tests.test_torch_models import port_config

SCHED = {"_name": "inverse_sqrt", "lr": 1e-3, "warmup_updates": 1}


@pytest.fixture(scope="module")
def tree():
    cfg = TINY
    params = {"params": jax_import.import_interlingua_state_dict(fairseq_state_dict(cfg, 2)[1])}
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _flat(t, path=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _flat(t[k], path + (k,))
    else:
        yield path, t


def _assert_trees(got, want, of_max=0.0):
    """Equal layouts (an empty ``{}`` is a leaf's place too) and leaves
    equal, or within ``of_max`` of each leaf's largest value."""
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for path in w:
        a, b = np.asarray(g[path]), np.asarray(w[path])
        assert a.shape == b.shape and a.dtype == b.dtype, path
        atol = of_max * float(np.abs(b).max()) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg="/".join(path))


def test_params_round_trip_the_flax_tree_bit_for_bit(tree):
    cfg, params = tree
    sd = params_from_flax(params)
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    model.load_state_dict(sd, strict=True)
    back = params_to_flax(model.state_dict())
    _assert_trees(back, params)
    assert all(a.dtype == np.float32 for _, a in _flat(back))


# (optimizer config, clip norm, --fix-* flags)
OPT_CASES = {
    "adam": ({"_name": "adam", "adam_betas": "(0.9, 0.98)"}, 0.0, ()),
    "adam_clip": ({"_name": "adam", "adam_betas": "(0.9, 0.98)"}, 0.5, ()),
    "adamw_clip": ({"_name": "adam", "weight_decay": 0.01}, 0.5, ()),
    "fix_wav2vec": ({"_name": "adam", "adam_betas": "(0.9, 0.98)"}, 0.0, ("fix_wav2vec",)),
    "fix_wav2vec_clip": ({"_name": "adam"}, 0.5, ("fix_wav2vec",)),
    "fix_decoder_interlingua": ({"_name": "adam"}, 0.0, ("fix_decoder", "fix_interlingua")),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adam_state_after_two_updates_matches_optax(tree, case):
    """The same gradients through optax (the JAX CLI's chain: clip, adam,
    the ``--fix-*`` mask) and through the port's optimizer: the parameters
    and ``state_to_optax`` equal optax's state as flax serialises it, its
    layout included; ``load_optax`` restores it."""
    opt_cfg, clip, fixes = OPT_CASES[case]
    cfg, params = tree
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.1,
                                    params) for _ in range(2)]
    sched = jax_schedule(SCHED)
    tx = jax_freeze.wrap_freeze(jax_optimizer(opt_cfg, sched, clip_norm=clip), params, fixes)
    p_j, s_j = jax.tree_util.tree_map(jnp.asarray, params), None
    s_j = tx.init(p_j)
    for g in grads:
        u, s_j = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s_j, p_j)
        p_j = optax.apply_updates(p_j, u)

    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    trained, frozen = freeze.wrap_freeze(model, fixes)
    opt = build_optimizer(opt_cfg, trained, clip_norm=clip, frozen=frozen)
    schedule = build_lr_schedule(SCHED)
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        for name, t in params_from_flax(g).items():
            named[name].grad = t
        opt.step(schedule(step), global_norm([p.grad for p in named.values()]))
    want_params = dict(_flat(jax.tree_util.tree_map(np.asarray, p_j)))
    got_params = dict(_flat(params_to_flax(model.state_dict())))
    assert sorted(got_params) == sorted(want_params)
    for path, w in want_params.items():
        np.testing.assert_allclose(got_params[path], w, atol=1e-4 * SCHED["lr"], rtol=2.0 ** -22,
                                   err_msg="/".join(path))
    got = opt.state_to_optax(model, 2)
    want = jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(s_j))
    _assert_trees(got, want, of_max=1e-6)
    # frozen parameters did not move and hold no moments
    for p in frozen:
        assert p not in opt.optimizer.state
    frozen_ids = {id(p) for p in frozen}
    start = params_from_flax(params)
    for name, p in named.items():
        if id(p) in frozen_ids:
            assert torch.equal(p.detach(), start[name]), name
    # the tree restores into a fresh optimizer of the same layout
    fresh = build_optimizer(opt_cfg, trained, clip_norm=clip, frozen=frozen)
    assert fresh.load_optax(got, model) == 2
    for p in trained:
        for k, v in opt.optimizer.state[p].items():
            assert torch.equal(v, fresh.optimizer.state[p][k]), k


def test_optimizer_state_of_another_layout_raises(tree):
    cfg, params = tree
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    opt = build_optimizer({"_name": "adam"}, model.parameters())
    masked = freeze.wrap_freeze(model, ("fix_wav2vec",))
    other = build_optimizer({"_name": "adam"}, masked[0], frozen=masked[1])
    with pytest.raises(ValueError, match="layout"):
        other.load_optax(opt.state_to_optax(model, 0), model)
    with pytest.raises(ValueError, match="layout"):
        build_optimizer({"_name": "adam"}, model.parameters(), clip_norm=1.0).load_optax(
            opt.state_to_optax(model, 0), model)


@pytest.mark.parametrize("fixes", [("fix_wav2vec",), ("fix_encoder_transformers",),
                                   ("fix_decoder",), ("fix_decoder_transformers",),
                                   ("fix_interlingua",), ("fix_wav2vec", "fix_decoder")])
def test_freeze_labels_match_jax(tree, fixes):
    cfg, params = tree
    want = dict(_flat(jax_freeze.freeze_labels(params, fixes)))
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu")
    got = freeze.freeze_labels(model, fixes)
    from chimera_st_tpu_torch.convert import torch_to_flax_path

    assert {("params",) + torch_to_flax_path("interlingua", n)[0]: lab
            for n, lab in got.items()} == want
    np.testing.assert_allclose(freeze.frozen_fraction(model, fixes),
                               jax_freeze.frozen_fraction(params, fixes), rtol=1e-12)


def test_frozen_parameters_keep_their_gradient_and_do_not_move(tree):
    """Two updates of the step with ``--fix-wav2vec``: the trunk is
    bit-identical after them, its gradient exists and the reported norm
    counts it."""
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep
    from tests.synthetic_data import make_triplet_dir
    import tempfile

    cfg, params = tree
    with tempfile.TemporaryDirectory() as root:
        make_triplet_dir(root, n=8, seed=3)
        task = setup_task({"_name": "triplet", "data": root, "config_yaml": "config_wave.yaml"})
        batch = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=4)
                          .next_epoch_itr(shuffle=False)))
    cfg = dataclasses.replace(cfg, tgt_vocab_size=len(task.target_dictionary),
                              src_vocab_size=len(task.source_dictionary))
    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu").train()
    from chimera_st_tpu_torch.models.interlingua import init_params_

    init_params_(model, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trained, frozen = freeze.wrap_freeze(model, ("fix_wav2vec",))
    step = TrainStep(model, task.build_criterion({"_name": "triplet_st_mt_contrastive"}),
                     build_optimizer({"_name": "adam"}, trained, frozen=frozen),
                     build_lr_schedule(SCHED), compute_dtype=torch.float32)
    for _ in range(2):
        m = step([batch], seed=1)
        assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in frozen)
        np.testing.assert_allclose(m["gnorm"], float(global_norm(
            [p.grad for p in model.parameters()])), rtol=1e-6)
        assert m["gnorm"] > float(global_norm([p.grad for p in trained]))
    names = {id(p): n for n, p in model.named_parameters()}
    for p in frozen:
        assert torch.equal(p.detach(), before[names[id(p)]])
    assert all(not torch.equal(p.detach(), before[names[id(p)]]) for p in trained
               if names[id(p)].endswith("weight"))


# one save sequence: (epoch, updates, validation metric, end of epoch)
SAVES = [(1, 2, 3.0, True), (2, 3, 2.5, False), (2, 4, 2.7, True), (3, 5, 2.4, False),
         (3, 6, None, True), (4, 8, 2.6, True), (5, 9, 2.2, False), (5, 10, 2.3, True)]
MANAGER_CASES = {
    "default": {},
    "keep_last_epochs": {"keep_last_epochs": 2},
    "keep_interval_updates": {"keep_interval_updates": 1},
    "keep_best_checkpoints": {"keep_best_checkpoints": 2},
    "keep_best_maximize": {"keep_best_checkpoints": 2, "maximize_best": True},
    "no_last_no_epoch": {"no_last": True, "no_epoch": True},
    "no_save": {"no_save": True},
    "no_optimizer_state": {"save_optimizer_state": False},
}


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_checkpoint_manager_files_and_best_match_jax(tmp_path, case):
    kw = MANAGER_CASES[case]
    params = {"params": {"w": np.arange(3, dtype=np.float32)}}
    opt = {"0": {"count": np.asarray(1, np.int32)}}

    class _JaxState:
        step, opt_state = 1, opt

    _JaxState.params = params
    jax_mgr = JaxManager(str(tmp_path / "jax"), **kw)
    port_mgr = CheckpointManager(str(tmp_path / "port"), **kw)
    for epoch, updates, val, end in SAVES:
        common = dict(val_metric=val, end_of_epoch=end, save_interval_updates=0 if end else 1)
        jax_mgr.save(_JaxState, {"x": updates}, epoch, updates, **common)
        port_mgr.save(lambda save_opt: TrainState(1, params, opt if save_opt else None),
                      {"x": updates}, epoch, updates, **common)
        assert port_mgr.best == jax_mgr.best
        names = sorted(p.name for p in (tmp_path / "port").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()), (epoch, updates)
    for name in names:
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        assert got["extra"] == want["extra"] and got["step"] == want["step"]
        _assert_trees(got["params"], want["params"])
        assert (got["opt_state"] is None) == (want["opt_state"] is None)


def _batches(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 100, size=int(rng.integers(1, 4))) for _ in range(n)]


def _order(itr):
    return [tuple(int(i) for i in b) for b in itr]


@pytest.mark.parametrize("shards", [(1, 0), (3, 1), (4, 3)])
def test_epoch_iterator_order_matches_jax_over_three_epochs(shards):
    num_shards, shard_id = shards
    batches = _batches()
    mk = dict(seed=5, num_shards=num_shards, shard_id=shard_id, buffer_size=2)
    a, b = EpochBatchIterator(list, batches, **mk), JaxIterator(list, batches, **mk)
    for epoch in range(1, 4):
        shuffle = epoch > 1
        assert len(a) == len(b)
        assert _order(a.next_epoch_itr(shuffle=shuffle)) == _order(b.next_epoch_itr(
            shuffle=shuffle))
        assert a.end_of_epoch() and b.end_of_epoch()
        a.next_epoch()
        b.next_epoch()
        assert a.state_dict() == b.state_dict()


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("offset", [0, 2, 11])
def test_epoch_iterator_resume_matches_jax(offset, num_workers):
    """A state of epoch 2 at ``offset`` (11: the epoch boundary, which
    bumps the epoch) restored in both packages, then grouped by 2 as the
    train loop does."""
    batches = _batches()
    state = {"epoch": 2, "iterations_in_epoch": offset, "shuffle": True}
    a = EpochBatchIterator(list, batches, seed=5, num_workers=num_workers)
    b = JaxIterator(list, batches, seed=5, num_workers=num_workers)
    a.load_state_dict(state)
    b.load_state_dict(state)
    assert a.epoch == b.epoch == (3 if offset == 11 else 2)
    assert a.state_dict() == b.state_dict()
    ia, ib = a.next_epoch_itr(shuffle=True), b.next_epoch_itr(shuffle=True)
    ga, gb = GroupedIterator(ia, 2), JaxGrouped(ib, 2)
    assert (ga.n, len(ga)) == (gb.n, len(gb))
    assert [[tuple(map(int, x)) for x in g] for g in ga] == \
        [[tuple(map(int, x)) for x in g] for g in gb]


def _meter_dicts(mod):
    d = mod.MetersDict()
    d.add_meter("loss", mod.AverageMeter(round=3), 10)
    d["loss"].update(2.5, 4)
    d["loss"].update(np.float32(1.5), 2)
    d.add_meter("sum", mod.SumMeter(), 20)
    d["sum"].update(3)
    d.add_meter("wps", mod.TimeMeter(round=1), 90)
    d["wps"].update(100)
    d.add_meter("wall", mod.StopwatchMeter(), 0)
    d["wall"].start()
    d["wall"].stop()
    d.add_meter("derived", mod.MetersDict._DerivedMeter(lambda m: 1.0), 5)
    return d


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_meters_state_dicts_read_in_both_directions(direction):
    src_mod, dst_mod = (meters, jax_meters) if direction == "port_to_jax" else \
        (jax_meters, meters)
    state = _meter_dicts(src_mod).state_dict()
    blob = pickle.dumps(state)
    assert b"chimera" not in blob  # names no class of either package
    restored = dst_mod.MetersDict()
    restored.load_state_dict(pickle.loads(blob))
    assert list(restored) == ["wall", "loss", "sum", "wps"]
    got = restored.get_smoothed_values()
    assert got["loss"] == round((2.5 * 4 + 1.5 * 2) / 6, 3) and got["sum"] == 3.0
    assert [(p, k, t) for p, k, t, _ in restored.state_dict()] == \
        [(p, k, t) for p, k, t, _ in state]


def _progress_lines(mod, fmt, logger_name):
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    log = logging.getLogger(logger_name)
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        bar = mod.progress_bar(list(range(4)), log_format=fmt, log_interval=2, epoch=3,
                               prefix="train")
        stats = {"loss": 2.34567, "n": 3, "big": 123456.0, "flag": True,
                 "arr": np.float32(0.5)}
        for i, _ in enumerate(bar):
            bar.log(stats, tag="train", step=i)
        bar.print(stats, tag="valid")
    finally:
        log.removeHandler(handler)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("fmt", ["json", "simple", "none"])
def test_progress_lines_match_jax(fmt):
    got = _progress_lines(progress_bar, fmt, "chimera_st_tpu_torch.logging.progress_bar")
    want = _progress_lines(jax_progress, fmt, "chimera_st_tpu.logging.progress_bar")
    assert got == want
    assert (len(got) == 0) == (fmt == "none")


_BLOCKED_PROBE = """
import sys
for name in ("tqdm", "tensorboardX", "tensorboard", "yaml", "sacrebleu", "sentencepiece",
             "jax", "flax", "chimera_st_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib
for m in ("logging.meters", "logging.metrics", "logging.progress_bar", "data.iterators",
          "optim.freeze", "checkpoint.store", "train.trainer", "cli.train", "cli.validate",
          "tools.auto_generate", "convert"):
    importlib.import_module("chimera_st_tpu_torch." + m)
from chimera_st_tpu_torch.logging.progress_bar import Progress, progress_bar
bar = progress_bar([1, 2], log_format="tqdm", tensorboard_logdir="tb")
assert type(bar) is Progress  # tqdm missing: the simple format
bar.log({"loss": 1.0}, step=1)  # the sink without tensorboardX writes nothing
print("ok")
"""


def test_new_modules_import_without_optional_wheels(tmp_path):
    """The trainer's modules import with tqdm, tensorboard(X), yaml,
    sacrebleu, sentencepiece and the JAX side unimportable; tqdm and the
    TensorBoard sink degrade as in the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _BLOCKED_PROBE], cwd=str(tmp_path),
                          env={"PYTHONPATH": str(Path(__file__).resolve().parents[1]),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_reset_encoder_matches_jax(tree):
    """``--reset-encoder``: the restored tree with the shared encoder's
    stack taken from the fresh one, as the JAX package's."""
    cfg, params = tree
    fresh = jax.tree_util.tree_map(lambda a: a + 1.0, params)
    want = jax_freeze.reset_encoder_subtrees(params, fresh)
    got = freeze.reset_encoder_subtrees(params_from_flax(params), params_from_flax(fresh))
    _assert_trees(params_to_flax(got), want)


def _tiny_trainer(cfg, fixes=()):
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.train import Trainer

    model = ChimeraInterlinguaModel(port_config(cfg), device="cpu").train()
    init_params_(model, torch.Generator().manual_seed(0))
    trained, frozen = freeze.wrap_freeze(model, fixes)
    opt = build_optimizer({"_name": "adam"}, trained, frozen=frozen)
    return Trainer(model, None, opt, build_lr_schedule(SCHED), compute_dtype=torch.float32)


@pytest.mark.parametrize("saved", ["no_optimizer_state", "other_layout"])
def test_restore_keeps_a_fresh_optimizer_state_with_a_warning(tree, saved, caplog):
    """As the JAX ``load_state``: a checkpoint without optimizer state, or
    with one of another layout (saved under ``--fix-wav2vec``), restores
    the parameters and the update count and keeps a fresh Adam state."""
    from chimera_st_tpu_torch.checkpoint.store import load_state

    cfg, _ = tree
    writer = _tiny_trainer(cfg, ("fix_wav2vec",) if saved == "other_layout" else ())
    writer.set_num_updates(7)
    host = writer.host_state(save_optimizer=saved != "no_optimizer_state")
    reader = _tiny_trainer(cfg)
    with torch.no_grad():
        for p in reader.model.parameters():
            p.add_(1.0)
    with caplog.at_level(logging.WARNING):
        extra = load_state({"step": host.step, "params": host.params,
                            "opt_state": host.opt_state, "extra": {"x": 1}}, reader)
    assert extra == {"x": 1} and reader.num_updates == 7
    assert any("freshly initialized optimizer state" in r.getMessage() for r in caplog.records)
    assert not reader.optimizer.optimizer.state
    for k, v in writer.model.state_dict().items():
        assert torch.equal(reader.model.state_dict()[k], v), k


def test_skipped_update_names_the_nonfinite_gradients(tree, caplog):
    """A NaN in the audio: the update is skipped, ``nonfinite_grad`` is
    logged and the warning names the parameters whose gradient is not
    finite (the JAX trainer's diagnosis)."""
    import tempfile

    from chimera_st_tpu_torch.tasks import setup_task
    from tests.synthetic_data import make_triplet_dir

    cfg, _ = tree
    with tempfile.TemporaryDirectory() as root:
        make_triplet_dir(root, n=4, seed=3)
        task = setup_task({"_name": "triplet", "data": root, "config_yaml": "config_wave.yaml"})
        batch = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=4)
                          .next_epoch_itr(shuffle=False)))
    cfg = dataclasses.replace(cfg, tgt_vocab_size=len(task.target_dictionary),
                              src_vocab_size=len(task.source_dictionary))
    trainer = _tiny_trainer(cfg)
    trainer.criterion = trainer.step.criterion = task.build_criterion(
        {"_name": "triplet_st_mt_contrastive"})
    bad = dict(batch, audio=batch["audio"].copy())
    bad["audio"][0, 10] = np.nan
    with caplog.at_level(logging.WARNING):
        out = trainer.train_step([bad], seed=1)
    assert out["nonfinite_grad"] == 1.0 and trainer.num_updates == 0
    warning = next(r.getMessage() for r in caplog.records if "non-finite" in r.getMessage())
    assert "update skipped" in warning and "encoder.wav2vec_model." in warning
