"""The zoo's language models and tutorial models against the JAX package on
the CPU: ``lstm_lm`` (with a tied output through ``out_proj_dim``),
``fconv_lm``, ``lightconv_lm`` / ``dynamicconv_lm``, ``rnn_classifier``
(a GRU) and ``dummy_model``: logits (or class log-probabilities) and every
gradient from the same seeded weights, within 1e-4 of the largest JAX value
of the tensor (``test_torch_zoo.check_model``). Then the train CLI of each
package in process on one binarized corpus: the JAX CLI trains ``lstm_lm``
for one update and the port resumes its checkpoint for one more; the port
refuses the run without ``--vocab-size``, where the JAX model trains on
NaN (ROADMAP C3), and ``eval_lm`` refuses the zoo LM it wrote."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.checkpoint.store import load_native_checkpoint
from chimera_st_tpu_torch.cli import eval_lm, preprocess, train
from tests.test_torch_zoo import check_model, jax_model, port_model

V = 21
TOKENS = np.array([[4, 9, 11, 5, 7, 2], [6, 3, 8, 2, 1, 1]], np.int32)

# case -> (arch, conversion table, tiny widths)
TINY_LM = {
    "lstm_lm": ("lstm_lm", "lstm_lm", dict(embed_dim=12, hidden_size=16, layers=2)),
    "lstm_lm_tied": ("lstm_lm", "lstm_lm", dict(embed_dim=12, hidden_size=16,
                                                share_input_output_embed=True)),
    "fconv_lm": ("fconv_lm", "fconv_lm", dict(embed_dim=16, layers=((16, 3), (24, 2), (24, 4)),
                                              out_embed_dim=12, max_positions=32)),
    "lightconv_lm": ("lightconv_lm", "lightconv_lm", dict(embed_dim=16, ffn_dim=24, layers=2,
                                                          heads=4, kernel_sizes=(3, 4))),
    "dynamicconv_lm": ("dynamicconv_lm", "lightconv_lm", dict(
        embed_dim=16, ffn_dim=24, layers=2, heads=2, kernel_sizes=(5,), normalize_before=False,
        share_input_output_embed=False)),
    "rnn_classifier": ("rnn_classifier", "rnn_classifier", dict(embed_dim=8, hidden_size=12,
                                                                num_classes=3)),
    "dummy_model": ("dummy_model", "dummy_model", dict(embed_dim=16, layers=2)),
}


@pytest.mark.parametrize("name", sorted(TINY_LM))
def test_lm_logits_and_gradients_match_jax(name):
    arch, table, widths = TINY_LM[name]
    cfg = dict(widths, vocab_size=V, dropout=0.1)
    port = port_model(arch, cfg)
    assert convert.model_kind(port) == table
    check_model(jax_model(arch, cfg), (jnp.asarray(TOKENS),), port,
                (torch.from_numpy(TOKENS).long(),), table, seed=sorted(TINY_LM).index(name) + 60)


LM_FLAGS = ["--task", "language_modeling", "--arch", "lstm_lm", "--embed-dim", "8",
            "--hidden-size", "8", "--tokens-per-sample", "16", "--criterion", "cross_entropy",
            "--optimizer", "adam", "--lr", "1e-3", "--max-tokens", "128", "--dtype", "float32",
            "--disable-validation", "--seed", "3"]


@pytest.fixture(scope="module")
def lm_bin(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_lm")
    rng = np.random.default_rng(5)
    rows = [" ".join(f"w{i}" for i in rng.integers(0, 20, size=int(rng.integers(3, 12))))
            for _ in range(24)]
    (root / "train.txt").write_text("\n".join(rows) + "\n")
    preprocess.main(["--only-source", "--trainpref", str(root / "train.txt"), "--destdir",
                     str(root / "bin")])
    return root


def test_each_package_trains_the_lm_and_the_port_resumes_the_jax_run(lm_bin):
    data = str(lm_bin / "bin")
    vocab = ["--vocab-size", "64"]
    jax_dir, port_dir = lm_bin / "jax", lm_bin / "port"
    jax_train.main([data, *LM_FLAGS, *vocab, "--max-update", "1", "--save-dir", str(jax_dir)])
    port_dir.mkdir()
    (port_dir / "checkpoint_last.ckpt").write_bytes((jax_dir / "checkpoint_last.ckpt")
                                                    .read_bytes())
    out = train.main([data, *LM_FLAGS, *vocab, "--max-update", "2", "--save-dir",
                      str(port_dir), "--device", "cpu"])
    assert out["trainer"].num_updates == 2
    tree, cfg = load_native_checkpoint(str(port_dir / "checkpoint_last.ckpt"))
    jax_tree, _ = load_native_checkpoint(str(jax_dir / "checkpoint_last.ckpt"))
    ours = convert.params_from_flax(tree, "lstm_lm")
    theirs = convert.params_from_flax(jax_tree, "lstm_lm")
    assert cfg["arch"] == "lstm_lm" and ours.keys() == theirs.keys()
    assert any(not torch.equal(ours[k], theirs[k]) for k in ours)  # the port's update moved them

    with pytest.raises(ValueError, match="--vocab-size"):
        train.main([data, *LM_FLAGS, "--max-update", "1", "--save-dir",
                    str(lm_bin / "novocab"), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP C3"):
        eval_lm.main([data, "--path", str(port_dir / "checkpoint_last.ckpt"), "--gen-subset",
                      "train", "--tokens-per-sample", "16", "--device", "cpu", "--dtype",
                      "float32"])
