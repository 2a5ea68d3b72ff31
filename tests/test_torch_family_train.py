"""Training the Transformer family in the port against the JAX package on
the CPU: ``transformer`` on ``translation`` with label-smoothed CE and
``transformer_lm`` on ``language_modeling`` with ``lm_cross_entropy`` and
``cross_entropy``; two accumulated updates against ``make_train_step``,
family checkpoints across the two packages without ``--reset-optimizer``,
the logged lines and BLEU validation of a ``transformer``.

A module fixture binarizes ``make_parallel_text`` (joined dictionary) and a
monolingual corpus with the port's preprocess and runs the JAX train CLI on
each family (2 + 2 layers, 32 wide, 4 heads, every dropout 0, Adam with
``inverse_sqrt`` lr 1e-3 over 2 warm-up updates, 4 updates with a save
every 2); the port's train CLI resumes a copy of each update-2 checkpoint to
update 4.

Tolerances are those of ``tests/test_torch_mt.py`` (fp32): parameters 1e-4
of the learning rate plus two fp32 roundings (2^-22 relative); Adam's
moments 1e-4 of each tensor's largest value; losses, gnorm and logged
scalars 1e-5 relative; decoded hypotheses identical.
"""

import dataclasses
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import load_state as jax_load_state
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch.cli import preprocess, train
from chimera_st_tpu_torch.convert import params_from_flax
from chimera_st_tpu_torch.models import transformer_mt
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.train import TrainStep
from tests.synthetic_data import make_parallel_text
from tests.test_torch_models import numpy_tree
from tests.test_torch_mt import TIMED, _Lines, _load, jax_serialized

LR = 1e-3
OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-3}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": LR, "warmup_updates": 2}
COMMON = ["--dropout", "0", "--attention-dropout", "0", "--activation-dropout", "0",
          "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-3", "--lr", str(LR),
          "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "2", "--max-update", "4",
          "--save-interval-updates", "2", "--dtype", "float32", "--log-format", "json",
          "--log-interval", "1"]
MT_WIDTHS = dict(encoder_embed_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=4,
                 decoder_embed_dim=32, decoder_ffn_dim=64, decoder_layers=2, decoder_heads=4)
LM_WIDTHS = dict(embed_dim=32, ffn_dim=64, layers=2, heads=4)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
FAMILIES = {
    "transformer": ["--task", "translation", "-s", "de", "-t", "en", "--arch", "transformer",
                    "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
                    "--batch-size", "8", "--best-checkpoint-metric", "bleu",
                    "--maximize-best-checkpoint-metric"],
    "transformer_lm": ["--task", "language_modeling", "--arch", "transformer_lm",
                       "--criterion", "lm_cross_entropy", "--tokens-per-sample", "16",
                       "--batch-size", "4"],
}


def _flags(widths):
    return [x for k, v in widths.items() for x in (f"--{k.replace('_', '-')}", str(v))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per family: the JAX run 0 -> 4 and the port's resume of its update-2
    checkpoint -> 4, their json lines, and the BLEU validations of the
    ``transformer`` runs."""
    sacrebleu = pytest.importorskip("sacrebleu", reason="BLEU validation needs sacrebleu")
    work = tmp_path_factory.mktemp("family")
    raw = make_parallel_text(str(work / "raw"))
    preprocess.main(["-s", "de", "-t", "en", "--trainpref", f"{raw}/train", "--validpref",
                     f"{raw}/valid", "--destdir", str(work / "mt"), "--joined-dictionary"])
    rng = np.random.default_rng(11)
    for split, n in (("train", 30), ("valid", 10)):
        rows = [" ".join(f"w{i}" for i in rng.zipf(1.5, size=int(rng.integers(3, 15))) % 25)
                for _ in range(n)]
        (work / f"{split}.txt").write_text("\n".join(rows) + "\n")
    preprocess.main(["--only-source", "--trainpref", str(work / "train.txt"), "--validpref",
                     str(work / "valid.txt"), "--destdir", str(work / "lm")])
    calls, corpus_bleu = [], sacrebleu.corpus_bleu

    def recorded(hyps, refs, *args, **kwargs):
        out = corpus_bleu(hyps, refs, *args, **kwargs)
        calls.append((list(hyps), out.score))
        return out

    out = {"work": work}
    sacrebleu.corpus_bleu = recorded
    try:
        for family, flags in FAMILIES.items():
            data = str(work / ("mt" if family == "transformer" else "lm"))
            argv = [data, *flags, *COMMON,
                    *_flags(MT_WIDTHS if family == "transformer" else LM_WIDTHS)]
            jax_dir, port_dir = work / f"jax_{family}", work / f"port_{family}"
            calls[:] = []
            with _Lines("chimera_st_tpu.logging.progress_bar") as jax_lines:
                jax_train.main(argv + ["--save-dir", str(jax_dir)])
            jax_bleu, calls[:] = list(calls), []
            port_dir.mkdir()
            shutil.copy(jax_dir / "checkpoint_1_2.ckpt", port_dir / "checkpoint_1_2.ckpt")
            with _Lines("chimera_st_tpu_torch.logging.progress_bar") as port_lines:
                result = train.main(argv + ["--save-dir", str(port_dir), "--restore-file",
                                            "checkpoint_1_2.ckpt", "--device", "cpu"])
            out[family] = dict(data=data, jax_dir=jax_dir, port_dir=port_dir,
                               jax_lines=jax_lines, port_lines=port_lines, out=result,
                               jax_bleu=jax_bleu, port_bleu=list(calls))
    finally:
        sacrebleu.corpus_bleu = corpus_bleu
    return out


def _micro_batches(task, split):
    """Two micro-batches of two rows each of the split's first batch."""
    batch = next(iter(task.make_batch_iterator(task.dataset(split), max_sentences=4)
                      .next_epoch_itr(shuffle=False)))
    micro = []
    for rows in (slice(0, 2), slice(2, 4)):
        half = {k: v[rows] for k, v in batch.items() if isinstance(v, np.ndarray)}
        half["ntokens"] = float((half["target"] != 1).sum())
        half["nsentences"] = 2
        micro.append(half)
    return micro


@pytest.mark.parametrize("family, criterion", [
    ("transformer", "label_smoothed_cross_entropy"), ("transformer_lm", "lm_cross_entropy"),
    ("transformer_lm", "cross_entropy")])
def test_family_updates_match_jax_train_step(runs, family, criterion):
    """Two updates of two micro-batches each: loss, nll_loss, gnorm, lr and
    every parameter after each update against ``make_train_step``, from
    the same weights (the flax init at key 0)."""
    data = runs[family]["data"]
    if family == "transformer":
        cfg = {"_name": "translation", "data": data, "source_lang": "de", "target_lang": "en"}
    else:
        cfg = {"_name": "language_modeling", "data": data, "tokens_per_sample": 16}
    task, jax_task = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    task.load_dataset("train")
    jax_task.load_dataset("train")
    micro = _micro_batches(task, "train")
    jax_micro = _micro_batches(jax_task, "train")
    for a, b in zip(micro, jax_micro):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    vocab = len(task.target_dictionary)
    if family == "transformer":
        jcfg = jax_mt.TransformerMTConfig(src_vocab_size=vocab, tgt_vocab_size=vocab,
                                          **NO_DROPOUT, **MT_WIDTHS)
        jm = jax_mt.TransformerModel(jcfg)
        init = jm.init(jax.random.PRNGKey(0), jnp.asarray(micro[0]["src_tokens"]),
                       jnp.asarray(micro[0]["prev_output_tokens"]))
        model = transformer_mt.build_transformer(dataclasses.asdict(jcfg), device="cpu")
    else:
        jcfg = jax_mt.TransformerLMConfig(vocab_size=vocab, **NO_DROPOUT, **LM_WIDTHS)
        jm = jax_mt.TransformerLM(jcfg)
        init = jm.init(jax.random.PRNGKey(0), jnp.asarray(micro[0]["net_tokens"]))
        model = transformer_mt.build_transformer_lm(dataclasses.asdict(jcfg), device="cpu")
    weights = jax.tree_util.tree_map(np.asarray, init)
    model.load_state_dict(params_from_flax(weights, family), strict=True)
    model.train()
    crit_cfg = {"_name": criterion, "label_smoothing": 0.1}
    sched = jax_build_lr_schedule(SCHED_CFG)
    tx = jax_build_optimizer(OPT_CFG, sched)
    jax_step = make_train_step(jm, JAX_CRITERIONS.get(criterion)({**crit_cfg, "padding_idx": 1}),
                               tx, accum_steps=2, lr_schedule=sched, donate=False)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, weights), tx)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]
               if k not in ("nsentences", "id")}
    step = TrainStep(model, task.build_criterion(crit_cfg),
                     build_optimizer(OPT_CFG, list(model.parameters())),
                     build_lr_schedule(SCHED_CFG), compute_dtype=torch.float32)
    for update in range(2):
        state, want = jax_step(state, stacked, jax.random.PRNGKey(update))
        got = step(micro)
        assert step.num_updates == int(state.step) == update + 1
        for k in ("loss", "nll_loss", "sample_size_total", "gnorm", "lr"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
        want_params = params_from_flax(numpy_tree(state.params), family)
        lr = max(got["lr"], LR)
        for k, w in want_params.items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(),
                                       atol=1e-4 * lr, rtol=2.0 ** -22,
                                       err_msg=f"update {update}: {k}")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_family_checkpoint_resumes_in_the_port_to_jax_parameters(runs, family):
    """The JAX run's update-2 checkpoint, resumed by the port's train CLI
    without ``--reset-optimizer``: at update 4 the port's parameters and
    Adam moments equal the uninterrupted JAX run's."""
    r = runs[family]
    assert r["out"]["times"]["restored"]["step"] == 2
    want_payload, got_payload = (_load(d / "checkpoint_last.ckpt")
                                 for d in (r["jax_dir"], r["port_dir"]))
    assert got_payload["step"] == want_payload["step"] == 4
    assert got_payload["extra"]["train_iterator"] == want_payload["extra"]["train_iterator"]
    assert got_payload["extra"]["model_cfg"]["arch"] == family
    want = params_from_flax(want_payload["params"], family)
    got = params_from_flax(got_payload["params"], family)
    held = r["out"]["trainer"].model.state_dict()
    assert set(got) == set(want) == set(held)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-4 * LR, rtol=2.0 ** -22,
                                   err_msg=k)
        assert torch.equal(got[k], held[k]), k
    trainer = r["out"]["trainer"]
    (w_state, w_count, w_sched), (g_state, g_count, g_sched) = (
        trainer.optimizer.read_optax(p["opt_state"], trainer.model)
        for p in (want_payload, got_payload))
    assert w_count == g_count == w_sched == g_sched == 4
    for key in ("mu", "nu"):
        assert set(w_state[key]) == set(g_state[key]) == set(held)
        for name, w in w_state[key].items():
            # a key projection's bias has an exact gradient of 0: its
            # moments are round-off, held against its weight's
            scale = w_state[key][name[:-4] + "weight"] if name.endswith("k_proj.bias") else w
            tol = 1e-4 * float(scale.abs().max()) + 1e-30
            np.testing.assert_allclose(g_state[key][name].numpy(), w.numpy(), atol=tol,
                                       rtol=0, err_msg=f"{name} {key}")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_family_checkpoint_restores_in_jax_without_reset(runs, family, caplog):
    """The port's ``checkpoint_last.ckpt`` of each family through the JAX
    ``load_state`` into the JAX CLI's template: no optimizer-reset warning,
    the step, the parameters and the port's Adam moments exactly."""
    r = runs[family]
    path = r["port_dir"] / "checkpoint_last.ckpt"
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
    trainer = r["out"]["trainer"]
    held = trainer.model.state_dict()
    for k, v in params_from_flax(numpy_tree(state.params), family).items():
        assert torch.equal(v, held[k]), k
    saved = jax.tree_util.tree_map(np.asarray, jax_serialized(state.opt_state))
    restored, count, schedule_count = trainer.optimizer.read_optax(saved, trainer.model)
    assert count == schedule_count == 4
    for name, p in trainer.model.named_parameters():
        s = trainer.optimizer.optimizer.state[p]
        assert torch.equal(restored["mu"][name], s["exp_avg"]), name
        assert torch.equal(restored["nu"][name], s["exp_avg_sq"]), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logged_family_lines_match_jax(runs, family):
    """The port logs updates 3 and 4; JAX's lines for the same updates."""
    r = runs[family]
    jax_lines = {line["update"]: line for line in r["jax_lines"]}
    assert len(r["port_lines"]) == 2
    for line in r["port_lines"]:
        want = jax_lines[line["update"]]
        assert set(line) == set(want)
        for key, value in line.items():
            # a meter another run in the process left (logged "None") equals JAX's too
            if key in TIMED or value == want[key]:
                continue
            np.testing.assert_allclose(float(value), float(want[key]), rtol=1e-5,
                                       err_msg=f"update {line['update']}: {key}")


def test_bleu_validation_of_a_transformer_matches_jax(runs):
    """``--best-checkpoint-metric bleu`` decodes the valid split through the
    port's generator (K1 and K3 on the card): the resumed run's validations
    at update 4 give JAX's hypotheses and BLEU, and the saved metric is
    that BLEU."""
    r = runs["transformer"]
    assert r["port_bleu"] and len(r["jax_bleu"]) == len(r["port_bleu"]) + 1
    for (gh, gs), (wh, ws) in zip(r["port_bleu"], r["jax_bleu"][1:]):
        assert gh == wh and len(gh) == 8
        assert gs == ws
    want, got = (_load(d / "checkpoint_last.ckpt")["extra"]
                 for d in (r["jax_dir"], r["port_dir"]))
    assert got["val_loss"] == want["val_loss"]


def test_family_refuses_the_audio_trunks_options(runs, tmp_path):
    """``--w2v2-model-path`` and ``--fix-*`` name parts of the interlingua
    model; a family model has none, so the train CLI raises."""
    r = runs["transformer_lm"]
    base = [r["data"], *FAMILIES["transformer_lm"], *COMMON, *_flags(LM_WIDTHS),
            "--save-dir", str(tmp_path), "--device", "cpu"]
    for flags in (["--fix-decoder"], ["--w2v2-model-path", "w.pt"]):
        with pytest.raises(ValueError, match="--fix-"):
            train.main(base + flags)
