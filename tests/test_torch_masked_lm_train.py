"""Training the masked-LM family in the port against the JAX package on the
CPU: every batch of two epochs array for array (the BERT masks, the
language resampling, the sentence pairs, the denoising noise), one update
of the ``masked_lm`` and ``legacy_masked_lm`` criteria (loss, gnorm, every
gradient and the Adam update), ``cli.train`` of each task, the XLM warm
start through the task's hook, the checkpoints carried across both ways,
``cli.validate --task masked_lm`` against the JAX CLI, and the
sequence-to-sequence hub over the XLM-initialised model.

Data: ``tests/test_torch_bart.py`` ``make_bart_data`` (a 37-word
vocabulary; ``mono`` with its ``en_XX`` / ``ro_RO`` folders, ``mt`` with
the de-en pairs). Widths: 2 layers, 32 wide, 4 heads, every dropout 0.
Tolerances: batches identical; the update's values 1e-5 absolute and
relative; checkpoints bit for bit.
"""

import dataclasses
import logging
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import load_state as jax_load_state
from chimera_st_tpu.cli import options as jax_options
from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.cli import validate as jax_validate
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.logging import metrics as jax_metrics
from chimera_st_tpu.optim import build_lr_schedule as jax_build_lr_schedule
from chimera_st_tpu.optim import build_optimizer as jax_build_optimizer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.cli import generate, options, train, validate
from chimera_st_tpu_torch.logging import metrics
from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.train import TrainStep
from chimera_st_tpu_torch.train.train_step import prepare_batch
from tests.test_torch_bart import WIDTHS, data  # noqa: F401 — the data fixture
from tests.test_torch_bart_train import NO_DROPOUT, _same_batch
from tests.test_torch_models import numpy_tree
from tests.test_torch_mt import jax_serialized

TOL = dict(atol=1e-5, rtol=1e-5)
MLM_WIDTHS = dict(embed_dim=32, ffn_dim=64, layers=2, heads=4)
BLOCKS = {"tokens_per_sample": 16, "sample_break_mode": "complete"}
# case -> (data key, task config, model config, criterion config)
TASKS = {
    "masked_lm": ("mono", {"_name": "masked_lm", **BLOCKS}, {"arch": "roberta_base"},
                  {"_name": "masked_lm"}),
    "cross_lingual_lm": ("mono", {"_name": "cross_lingual_lm", "monolingual_langs":
                                  "en_XX,ro_RO", "multilang_sampling_alpha": 0.7, **BLOCKS},
                         {"arch": "xlm_base"}, {"_name": "masked_lm"}),
    "multilingual_masked_lm": ("mono", {"_name": "multilingual_masked_lm",
                                        "multilang_sampling_alpha": 0.5,
                                        "tokens_per_sample": 24},
                               {"arch": "roberta_base"}, {"_name": "masked_lm"}),
    "legacy_masked_lm": ("mono", {"_name": "legacy_masked_lm"}, {"arch": "bert_base"},
                         {"_name": "legacy_masked_lm"}),
    "semisupervised_translation": ("mt", {"_name": "semisupervised_translation",
                                          "source_lang": "de", "target_lang": "en",
                                          "lambda_denoising": 1.0, "word_dropout": 0.2},
                                   {"arch": "transformer"},
                                   {"_name": "label_smoothed_cross_entropy"}),
    "translation_from_pretrained_xlm": ("mt", {"_name": "translation_from_pretrained_xlm",
                                               "source_lang": "de", "target_lang": "en"},
                                        {"arch": "transformer_from_pretrained_xlm",
                                         "encoder_normalize_before": False},
                                        {"_name": "label_smoothed_cross_entropy"}),
}


@pytest.fixture(autouse=True)
def fresh_meters():
    """No run here leaves meters in either package's global aggregators for
    the next test of this process."""
    yield
    jax_metrics.reset()
    metrics.reset()


def task_pair(data, case, split="train"):
    key, cfg, _, _ = TASKS[case]
    cfg = {**cfg, "data": str(data[key])}
    task, jax_task = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    for t in (task, jax_task):
        t.load_dataset(split)
    return task, jax_task


@pytest.mark.parametrize("case", sorted(set(TASKS) - {"translation_from_pretrained_xlm"}))
def test_batches_match_jax_over_two_epochs(data, case):
    """Every batch of epochs 1 and 2 array for array against JAX's; the
    masks and the language mixture are drawn anew in epoch 2, the denoising
    noise of ``semisupervised_translation`` is not: ``NoisingDataset`` draws
    from (seed, index), without the epoch, in JAX as here (ROADMAP C)."""
    task, jax_task = task_pair(data, case)
    its = [t.make_batch_iterator(t.dataset("train"), max_sentences=4, seed=3,
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
    semi = case == "semisupervised_translation"
    key = "src_tokens" if semi else "net_tokens"
    assert semi != any(a[key].shape != b[key].shape or not np.array_equal(a[key], b[key])
                       for a, b in zip(*epochs))
    if case == "legacy_masked_lm":
        d = task.target_dictionary
        b = epochs[0][0]
        assert (b["net_tokens"][:, 0] == d.bos()).all() and set(b["sentence_target"]) <= {0, 1}
        assert ((b["net_tokens"] == d.index("<sep>")).sum(1) >= 1).all()


def test_cross_lingual_masks_never_reroll_in_either_package(data):
    """A language's block keeps epoch 1's mask in epoch 2: the per-language
    view has no ``set_epoch`` in JAX (``tasks/lm_tail.py:47-71``), and the
    port keeps it so (ROADMAP C); ``masked_lm`` re-rolls."""
    for case, rerolls in (("cross_lingual_lm", False), ("masked_lm", True)):
        for t in task_pair(data, case, "valid"):
            ds = t.dataset("valid")
            first = [ds[i]["net_tokens"].copy() for i in range(len(ds))]
            ds.set_epoch(2)
            again = [ds[i]["net_tokens"] for i in range(len(ds))]
            same = all(np.array_equal(a, b) for a, b in zip(first, again))
            assert same != rerolls, case


# ------------------------------------------------------------------ updates

LR = 1e-3
OPT_CFG = {"_name": "adam", "adam_betas": "(0.9, 0.98)", "adam_eps": 1e-6}
SCHED_CFG = {"_name": "inverse_sqrt", "lr": LR, "warmup_updates": 2}


def _jax_model_and_weights(jax_task, model_cfg, tokens, seed=0):
    from tests.test_torch_transformer import seeded_tree

    jm = jax_task.build_model(dict(model_cfg))
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(tokens)))
    return jm, seeded_tree(init(jax.random.PRNGKey(0)), seed)


@pytest.mark.parametrize("case", ["masked_lm", "legacy_masked_lm"])
def test_one_update_matches_jax(data, case):
    """One update of two micro-batches: every gradient of the first's loss
    over its sample size against ``jax.grad`` of the JAX criterion's, then
    loss, sample size, gnorm, lr and every parameter after the Adam update
    against ``make_train_step``."""
    task, jax_task = task_pair(data, case)
    _, _, model_cfg, crit_cfg = TASKS[case]
    model_cfg = {**model_cfg, **MLM_WIDTHS, "dropout": 0.0}
    batch = next(b for b in task.make_batch_iterator(task.dataset("train"), max_sentences=6)
                 .next_epoch_itr(shuffle=False) if len(b["id"]) == 6)
    micro = []
    for rows in (slice(0, 3), slice(3, 6)):
        half = {k: v[rows] for k, v in batch.items() if isinstance(v, np.ndarray)}
        half["ntokens"], half["nsentences"] = float((half["target"] != 1).sum()), 3
        micro.append(half)
    jm, weights = _jax_model_and_weights(jax_task, model_cfg, micro[0]["net_tokens"], seed=2)
    model = task.build_model(dict(model_cfg), device="cpu", train=True)
    model.load_state_dict(convert.params_from_flax(weights, "masked_lm"), strict=True)
    crit = task.build_criterion(crit_cfg)
    jax_crit = JAX_CRITERIONS.get(crit_cfg["_name"])({"padding_idx": 1})
    if case == "legacy_masked_lm":
        assert model.cfg.sentence_class_num == 2

    jb = {k: jnp.asarray(v) for k, v in micro[0].items() if k != "id"}

    def jax_loss(p):  # the loss over its sample size, as the update takes it
        loss, ss, _ = jax_crit(jm, p, jb, train=False)
        return loss / ss

    want_grads = jax.jit(jax.grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, weights))
    loss, ss, _ = crit(model, prepare_batch(micro[0], "cpu"))
    (loss / ss).backward()
    for k, g in convert.params_from_flax(numpy_tree(want_grads), "masked_lm").items():
        np.testing.assert_allclose(model.get_parameter(k).grad.numpy(), g.numpy(), **TOL,
                                   err_msg=k)
    model.zero_grad(set_to_none=True)

    sched = jax_build_lr_schedule(SCHED_CFG)
    tx = jax_build_optimizer(OPT_CFG, sched)
    jax_step = make_train_step(jm, jax_crit, tx, accum_steps=2, lr_schedule=sched, donate=False)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, weights), tx)
    stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]
               if k != "nsentences"}
    step = TrainStep(model, crit, build_optimizer(OPT_CFG, list(model.parameters())),
                     build_lr_schedule(SCHED_CFG), compute_dtype=torch.float32)
    state, want = jax_step(state, stacked, jax.random.PRNGKey(0))
    got = step(micro)
    for k in ("loss", "sample_size_total", "gnorm", "lr"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    for k, w in convert.params_from_flax(numpy_tree(state.params), "masked_lm").items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), w.numpy(), **TOL, err_msg=k)


# --------------------------------------------------------------------- CLIs

def train_argv(data, case, save_dir, max_update=2, extra=()):
    key, cfg, model_cfg, crit_cfg = TASKS[case]
    flags = []
    for k, v in {**cfg, **model_cfg, **WIDTHS, **MLM_WIDTHS, **NO_DROPOUT}.items():
        if k != "_name":
            flags += [f"--{k.replace('_', '-')}", str(v)]
    return [str(data[key]), "--task", cfg["_name"], *flags, "--criterion", crit_cfg["_name"],
            "--optimizer", "adam", "--adam-betas", "(0.9,0.98)", "--adam-eps", "1e-6",
            "--weight-decay", "0.01", "--clip-norm", "0.0", "--lr-scheduler",
            "polynomial_decay", "--lr", "0.0005", "--total-num-update", "10",
            "--warmup-updates", "1", "--batch-size", "6", "--max-update", str(max_update),
            "--dtype", "float32", "--num-length-buckets", "2", "--save-dir", str(save_dir),
            "--device", "cpu", "--log-interval", "1", *extra]


@pytest.fixture(scope="module")
def xlm_ckpt(data, tmp_path_factory):
    """A JAX-written ``.ckpt`` of ``xlm_base`` at the small widths over the
    de-en source dictionary and ``<mask>`` (the size of the translation
    task's dictionaries plus one: only its layers fit the transformer)."""
    path = tmp_path_factory.mktemp("xlm") / "xlm.ckpt"
    jax_task = jax_setup_task({**TASKS["masked_lm"][1], "data": str(data["mono"])})
    model_cfg = {"arch": "xlm_base", **MLM_WIDTHS, "dropout": 0.0}
    _, weights = _jax_model_and_weights(jax_task, model_cfg, np.full((2, 4), 5, np.int32), 4)
    jax_save_state(str(path), type("S", (), {"step": 0, "params": weights,
                                             "opt_state": None})(),
                   {"model_cfg": model_cfg}, save_optimizer=False)
    return path


def test_xlm_warm_start_matches_jax(data, xlm_ckpt):
    """``post_init_params`` of both tasks over one fresh transformer, from
    the JAX-written XLM checkpoint: every tensor equal after the merge; the
    encoder's layers are the XLM's."""
    task, jax_task = task_pair(data, "translation_from_pretrained_xlm", "valid")
    model_cfg = {**TASKS["translation_from_pretrained_xlm"][2], **WIDTHS, **NO_DROPOUT,
                 "encoder_layers": 2}
    for t in (task, jax_task):
        t.cfg["pretrained_xlm_checkpoint"] = str(xlm_ckpt)
    jm = jax_task.build_model(dict(model_cfg))
    src = jnp.full((2, 4), 5, jnp.int32)
    fresh = numpy_tree(jax.jit(lambda k: jm.init(k, src, src))(jax.random.PRNGKey(1)))
    want = jax_task.post_init_params(fresh, jm, None)
    model = task.build_model(dict(model_cfg), device="cpu", train=True)
    model.load_state_dict(convert.params_from_flax(fresh, "transformer"), strict=True)
    task.post_init_params(model)
    held = model.state_dict()
    for k, v in convert.params_from_flax(numpy_tree(want), "transformer").items():
        assert torch.equal(held[k], v), k
    xlm = convert.params_from_flax(pickle.loads(xlm_ckpt.read_bytes())["params"], "masked_lm")
    assert torch.equal(held["encoder.layers.1.fc2.weight"], xlm["layers.1.fc2.weight"])
    assert not torch.equal(held["encoder.embed_tokens.weight"][:5],
                           xlm["embed_tokens.weight"][:5])  # the sizes differ: not copied


@pytest.mark.parametrize("case", sorted(TASKS))
def test_cli_train_runs_each_task(data, case, tmp_path, xlm_ckpt, capsys):
    """``cli.train`` of the task on the CPU with fairseq's RoBERTa flags:
    two updates, validation, a checkpoint that stores the arch; finite
    losses (the XLM task starts from the JAX-written checkpoint). The two
    translation tasks' checkpoints are served by ``cli.generate`` and by
    ``hub.from_pretrained(...).translate``, with the same hypotheses."""
    extra = (["--pretrained-xlm-checkpoint", str(xlm_ckpt)]
             if case == "translation_from_pretrained_xlm" else [])
    out = train.main(train_argv(data, case, tmp_path, extra=extra))
    assert out["trainer"].num_updates == 2
    assert all(np.isfinite(v) for v in out["times"]["valid"])
    ckpt = tmp_path / "checkpoint_last.ckpt"
    payload = pickle.loads(ckpt.read_bytes())
    assert payload["step"] == 2
    assert payload["extra"]["model_cfg"]["arch"] == TASKS[case][2]["arch"]
    if case not in ("translation_from_pretrained_xlm", "semisupervised_translation"):
        return
    from chimera_st_tpu_torch import hub

    capsys.readouterr()
    generate.main([str(data["mt"]), "--task", case, "-s", "de", "-t", "en", "--path",
                   str(ckpt), "--gen-subset", "test", "--beam", "2", "--max-decode-len", "6",
                   "--batch-size", "1", "--dtype", "float32", "--scoring", "bleu",
                   "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    src = {l.split("\t")[0][2:]: l.split("\t")[1] for l in lines if l.startswith("S-")}
    hyp = {l.split("\t")[0][2:]: l.split("\t")[2] for l in lines if l.startswith("H-")}
    assert len(src) == len(hyp) == 6
    m = hub.from_pretrained(str(ckpt), data_dir=str(data["mt"]), task=case, device="cpu",
                            source_lang="de", target_lang="en")
    ids = sorted(src)
    assert m.translate([src[i] for i in ids], beam=2, max_decode_len=6) == [hyp[i] for i in ids]


README_FLAGS = ["--tokens-per-sample", "512", "--sample-break-mode", "complete", "--optimizer",
                "adam", "--adam-betas", "(0.9,0.98)", "--adam-eps", "1e-6", "--weight-decay",
                "0.01", "--clip-norm", "0.0", "--lr-scheduler", "polynomial_decay", "--lr",
                "0.0005", "--warmup-updates", "10000", "--total-num-update", "125000",
                "--dropout", "0.1", "--attention-dropout", "0.1", "--max-sentences", "16",
                "--update-freq", "16"]


@pytest.mark.parametrize("arch", ["roberta_base", "bert_base", "xlm_base"])
def test_readme_flags_reach_the_same_fields(data, arch):
    """fairseq's ``examples/roberta`` pre-training flags parse to the same
    arguments, task and model config in both packages: ``--dropout`` is the
    model's attention dropout too, ``--attention-dropout`` reaches no field
    in either (ROADMAP C)."""
    argv = [str(data["mono"]), "--task", "masked_lm", "--arch", arch, *README_FLAGS]
    out = []
    for opts, setup in ((jax_options, jax_setup_task), (options, setup_task)):
        p = opts.base_parser("x")
        opts.add_train_args(p)
        args, extra = opts.parse_with_model_overrides(p, argv)
        task = setup({"_name": args.task, "data": args.data, **extra})
        kw = {} if setup is jax_setup_task else {"device": "cpu"}
        cfg = dataclasses.asdict(task.build_model({"arch": args.arch, **extra}, **kw).cfg)
        fields = ("lr", "adam_betas", "adam_eps", "weight_decay", "clip_norm", "lr_scheduler",
                  "warmup_updates", "total_num_update", "batch_size", "update_freq")
        out.append(({f: getattr(args, f) for f in fields}, extra, task.cfg, cfg))
    assert out[0] == out[1]
    cfg = out[1][3]
    assert cfg["dropout"] == 0.1 and "attention_dropout" not in cfg
    assert out[1][2]["tokens_per_sample"] == 512


ROUND_TRIPS = ("masked_lm", "legacy_masked_lm")


@pytest.mark.parametrize("case", ROUND_TRIPS)
def test_checkpoints_cross_both_ways(data, case, tmp_path, caplog):
    """A JAX train state (its init and Adam) saved by the JAX store resumes
    in the port's ``cli.train`` for two updates; the JAX ``load_state``
    restores the port's checkpoint without an optimizer reset: the step,
    every parameter and Adam moment as the port holds them."""
    key, cfg, model_cfg, _ = TASKS[case]
    model_cfg = {**model_cfg, **MLM_WIDTHS, "dropout": 0.0}
    jax_task = jax_setup_task({**cfg, "data": str(data[key])})
    jax_task.load_dataset("train")
    jm = jax_task.build_model(dict(model_cfg))

    class _Args:
        seed = 1
        w2v2_model_path = None

    template = jax_train.init_params_for_task(jm, jax_task, _Args())
    tx = jax_build_optimizer({**OPT_CFG, "weight_decay": 0.01},
                             jax_build_lr_schedule(SCHED_CFG))
    start = create_train_state(template, tx)
    (tmp_path / "run").mkdir()
    jax_save_state(str(tmp_path / "run" / "checkpoint_last.ckpt"), start,
                   {"model_cfg": model_cfg, "task_cfg": {**cfg, "data": str(data[key])}})
    out = train.main(train_argv(data, case, tmp_path / "run", 2, ["--disable-validation"]))
    assert out["times"]["restored"]["step"] == 0 and out["trainer"].num_updates == 2
    with caplog.at_level(logging.WARNING):
        state, _ = jax_load_state(str(tmp_path / "run" / "checkpoint_last.ckpt"), start)
    assert not [r for r in caplog.records if "optimizer state" in r.getMessage()]
    assert int(state.step) == 2
    trainer = out["trainer"]
    held = trainer.model.state_dict()
    restored = convert.params_from_flax(numpy_tree(state.params), "masked_lm")
    assert set(restored) == set(held)
    for k, v in restored.items():
        assert torch.equal(v, held[k]), k
    moments, count, _ = trainer.optimizer.read_optax(
        jax.tree_util.tree_map(np.asarray, jax_serialized(state.opt_state)), trainer.model)
    assert count == 2
    for n, p in trainer.model.named_parameters():
        assert torch.equal(moments["mu"][n], trainer.optimizer.optimizer.state[p]["exp_avg"]), n


def test_validate_matches_the_jax_cli(data, tmp_path, capsys):
    """``cli.validate --task masked_lm`` on a port-written checkpoint: the
    loss line within 1e-5 of the JAX validate CLI's (at the task's default
    blocks: the JAX CLI passes no undeclared flag to the task, ROADMAP C)."""
    train.main(train_argv(data, "masked_lm", tmp_path, extra=["--disable-validation"]))
    argv = [str(data["mono"]), "--task", "masked_lm", "--path",
            str(tmp_path / "checkpoint_last.ckpt"), "--valid-subset", "valid",
            "--criterion", "masked_lm", "--batch-size", "4", "--num-length-buckets", "2",
            "--dtype", "float32"]
    capsys.readouterr()
    jax_validate.main(argv + ["--arch", "roberta_base"])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = validate.main(argv + ["--device", "cpu"])
    want = dict(kv.split() for kv in want.split(" | "))
    assert set(want) == set(got) == {"loss", "nll_loss"}
    for k, v in got.items():
        assert v == pytest.approx(float(want[k]), rel=1e-5, abs=1e-4), k
