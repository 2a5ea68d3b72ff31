"""The zoo's tasks and criterions against the JAX package on the CPU:

- ``dummy_mt`` / ``dummy_lm`` / ``dummy_masked_lm``: the same dictionary
  and batches, array-equal;
- ``simple_classification`` end to end: the same batches from the same
  files, and ``rnn_classifier``'s loss and hits under its criterion from
  converted weights (1e-5);
- ``label_smoothed_cross_entropy_with_alignment`` on hand-built alignment
  batches (-1 pads, a target position with two links) over a small
  Transformer: loss, NLL and alignment loss within 1e-5 of JAX's;
- the train CLI refusing the zoo's encoder-decoders (ROADMAP C3) and the
  decoding CLIs refusing any zoo model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chimera_st_tpu.criterions  # noqa: F401 — registration
import chimera_st_tpu.tasks  # noqa: F401
from chimera_st_tpu.config.registry import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.cli import generate, train
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.train.train_step import prepare_batch
from tests.test_torch_transformer import PREV, SMALL, SRC, VARIANTS, port_mt_model
from tests.test_torch_zoo import jax_params, port_model


def first_batch(task, split="train", **kw):
    task.load_dataset(split)
    itr = task.make_batch_iterator(task.dataset(split), **kw)
    return next(iter(itr.next_epoch_itr(shuffle=False)))


def assert_same_batch(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("task", ["dummy_mt", "dummy_lm", "dummy_masked_lm"])
def test_dummy_batches_are_array_equal_to_jax(task):
    cfg = {"_name": task, "data": "unused", "dict_size": 57, "dataset_size": 12,
           "tokens_per_sample": 40, "src_len": 9, "tgt_len": 7}
    ours, theirs = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    assert len(ours.target_dictionary) == len(theirs.target_dictionary)
    assert_same_batch(first_batch(ours, max_sentences=5), first_batch(theirs, max_sentences=5))


@pytest.fixture(scope="module")
def cls_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(2)
    (root / "dict.input.txt").write_text("".join(f"w{i} {30 - i}\n" for i in range(30)))
    (root / "dict.label.txt").write_text("pos 5\nneg 4\nneutral 2\n")
    for split, n in (("train", 12), ("valid", 5)):
        rows = [" ".join(f"w{i}" for i in rng.integers(0, 34, size=int(rng.integers(2, 20))))
                for _ in range(n)]  # w30..w33 are unknown
        (root / f"{split}.input").write_text("\n".join(rows) + "\n")
        (root / f"{split}.label").write_text(
            "\n".join(rng.choice(["pos", "neg", "neutral"], n)) + "\n")
    return root


def test_simple_classification_end_to_end(cls_dir):
    cfg = {"_name": "simple_classification", "data": str(cls_dir)}
    ours, theirs = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    got, want = (first_batch(t, "valid", max_sentences=8) for t in (ours, theirs))
    assert_same_batch(got, want)
    assert got["net_tokens"].shape[1] % 16 == 0

    model_cfg = {"arch": "rnn_classifier", "embed_dim": 8, "hidden_size": 12}
    jm = theirs.build_model(dict(model_cfg))
    port = ours.build_model(dict(model_cfg), device="cpu")
    params = jax_params(jm, 4, jnp.asarray(want["net_tokens"]))
    port.load_state_dict(convert.params_from_flax(params, "rnn_classifier"), strict=True)
    jax_crit = theirs.build_criterion({"_name": "simple_classification"})
    jloss, jn, jlog = jax.jit(lambda p, b: jax_crit(jm, p, b, train=False))(
        params, {k: jnp.asarray(v) for k, v in want.items() if k != "nsentences"})
    loss, n, log = ours.build_criterion({"_name": "simple_classification"})(
        port, prepare_batch(got, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert n == float(jn) == 5 and float(log["ncorrect"]) == float(jlog["ncorrect"])


def test_alignment_loss_matches_jax():
    jm = jax_mt.TransformerModel(jax_mt.TransformerMTConfig(**SMALL,
                                                            **VARIANTS["sinusoid_pre_norm"]))
    params = jax_params(jm, 7, jnp.asarray(SRC), jnp.asarray(PREV))
    port = port_mt_model(jm, params)
    batch = {"src_tokens": SRC, "prev_output_tokens": PREV,
             "target": np.concatenate([PREV[:, 1:], np.full((3, 1), 2, np.int32)], axis=1),
             "ntokens": 11.0,
             # (target, source) links; row 0 links target 1 twice, -1 pads
             "alignment_tgt": np.array([[0, 1, 1, 3], [0, 1, -1, -1], [2, 0, 4, -1]], np.int32),
             "alignment_src": np.array([[0, 2, 3, 5], [1, 0, -1, -1], [4, 4, 0, -1]], np.int32)}
    name = "label_smoothed_cross_entropy_with_alignment"
    cfg = {"_name": name, "label_smoothing": 0.1, "alignment_lambda": 0.3}
    jax_crit = JAX_CRITERIONS.get(name)(cfg)
    jloss, _, jlog = jax.jit(lambda p, b: jax_crit(jm, p, b, train=False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    from chimera_st_tpu_torch.config.registry import CRITERIONS

    loss, _, log = CRITERIONS.get(name)(cfg)(port, prepare_batch(batch, "cpu"))
    for key, want in (("loss", jloss), ("nll_loss", jlog["nll_loss"]),
                      ("alignment_loss", jlog["alignment_loss"])):
        np.testing.assert_allclose(float(log[key]), float(want), rtol=1e-5, err_msg=key)
    assert float(log["alignment_loss"]) > 0 and float(loss) == float(log["loss"])


@pytest.mark.parametrize("arch", ["fconv_iwslt_de_en", "s2t_berard_512_5_3", "dummy_model"])
def test_train_cli_refuses_the_models_the_jax_cli_cannot_initialise(arch, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        train.main([str(tmp_path), "--task", "translation", "--arch", arch, "--device", "cpu"])


def test_decoding_clis_refuse_a_zoo_model():
    model = port_model("lstm_wiseman_iwslt_de_en", {"src_vocab_size": 9, "tgt_vocab_size": 9,
                                                    "embed_dim": 8, "hidden_size": 8})
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        generate.require_decoder(model)
