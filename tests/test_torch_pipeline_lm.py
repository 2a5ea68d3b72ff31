"""The stacked pipeline LM of the PyTorch port
(``chimera_st_tpu_torch/models/pipeline_lm.py``, ``transformer_lm_pipe``)
against the JAX package's ``PipelinedTransformerLM`` and against the port's
own plain ``transformer_lm`` on the CPU: the logits of a ``transformer_lm``
state dict stacked into the pipe layout equal the plain LM's and JAX's
(fp32, 1e-5), stacking and unstacking equal JAX's on the same weights, and
a JAX ``.ckpt`` tree of the pipe model crosses to the port and back leaf
for leaf. The GPipe schedule itself over several ranks is held in
``tests/test_torch_parallel.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chimera_st_tpu.models import pipeline_lm as jax_pipe
from chimera_st_tpu.models.transformer_mt import TransformerLMConfig as JaxLMConfig
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.models import pipeline_lm
from chimera_st_tpu_torch.models.transformer_mt import build_transformer_lm

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(vocab_size=40, embed_dim=32, ffn_dim=48, layers=4, heads=4, dropout=0.0,
             attention_dropout=0.0, activation_dropout=0.0)
TOKENS = np.random.default_rng(0).integers(3, 40, size=(4, 12)).astype(np.int64)
TOKENS[1, 9:] = 1  # padded


def _jax_tree():
    jm = jax_pipe.PipelinedTransformerLM(JaxLMConfig(**SMALL))
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(TOKENS, jnp.int32))
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), params)
    return jm, tree


def test_stacked_logits_equal_the_plain_lm_and_jax():
    jm, tree = _jax_tree()
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                               jnp.asarray(TOKENS, jnp.int32)))
    pipe = pipeline_lm.build_transformer_lm_pipe(dict(SMALL), device="cpu").eval()
    sd = convert.params_from_flax(tree, "transformer_lm_pipe")
    pipe.load_state_dict(sd, strict=True)
    plain = build_transformer_lm(dict(SMALL), device="cpu").eval()
    plain_sd = pipeline_lm.unstack_lm_params(sd)
    plain.load_state_dict(plain_sd, strict=True)
    with torch.no_grad():
        got = pipe(torch.from_numpy(TOKENS))
        got_plain = plain(torch.from_numpy(TOKENS))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_plain.numpy(), got.numpy(), atol=1e-6, rtol=1e-6)
    # the JAX stack / unstack give the same trees as the port's
    jax_plain = jax_pipe.unstack_lm_params(tree)
    np.testing.assert_array_equal(
        convert.params_to_flax(plain_sd, "transformer_lm")["params"]["decoder"]["layers_2"]
        ["fc1"]["kernel"], np.asarray(jax_plain["params"]["decoder"]["layers_2"]["fc1"]["kernel"]))
    restacked = pipeline_lm.stack_lm_params(plain_sd, SMALL["layers"])
    jax_restacked = jax_pipe.stack_lm_params(jax_plain, SMALL["layers"])
    back = convert.params_to_flax(restacked, "transformer_lm_pipe")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_restacked["params"]):
        node = back["params"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))


def test_a_jax_checkpoint_crosses_both_ways():
    _, tree = _jax_tree()
    sd = convert.params_from_flax(tree, "transformer_lm_pipe")
    assert sd["scan_layers.layer.fc1.weight"].shape == (4, 48, 32)  # [L, out, in]
    back = convert.params_to_flax(sd, "transformer_lm_pipe")
    flat = jax.tree_util.tree_leaves_with_path(tree["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf), err_msg=str(path))
    pipe = pipeline_lm.build_transformer_lm_pipe(
        pipeline_lm.transformer_lm_pipe_base({"tgt_vocab_size": 40}), device="cpu")
    assert pipe.cfg.embed_dim == 512 and pipe.cfg.layers == 6 and pipe.cfg.dropout == 0.0
    assert pipe.cfg.vocab_size == 40
