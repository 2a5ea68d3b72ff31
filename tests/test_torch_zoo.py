"""The convolutional and recurrent encoder-decoder zoo of the port against
the JAX package on the CPU: ``fconv``, ``fconv_self_att`` (with the
downsampled self-attention and the pretrained-LM gating), ``lightconv`` and
its dynamic variant, ``lstm`` (bidirectional, with attention),
``simple_lstm``, and the modules they are built of (the shifted views,
``LightweightConv`` / ``DynamicConv``, ``VGGBlock``, ``AdaptiveInput``,
``sparse_attention_mask``).

The same seeded weights (numpy draws over a flax init's tree, converted by
``convert.params_from_flax``) and the same token batches, with pads, go
through both packages in fp32 (JAX at ``highest`` matmul precision):
teacher-forced logits within 1e-4 of the largest JAX logit and every
parameter's gradient of a seeded projection of the logits within 1e-4 of
the largest JAX gradient of the same tensor (each at least 1e-4). The zoo's recurrences run unpacked over the pads in both
packages (ROADMAP C)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chimera_st_tpu.models  # noqa: F401 — registration
from chimera_st_tpu.config.registry import ARCHITECTURES as JAX_ARCHITECTURES
from chimera_st_tpu.config.registry import MODELS as JAX_MODELS
from chimera_st_tpu.models import conv_attention as jax_ca
from chimera_st_tpu.models import fconv as jax_fconv
from chimera_st_tpu.models import modules_extra as jax_mod
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.models import conv_attention, fconv_self_att, modules_extra
from chimera_st_tpu_torch.tasks import setup_task  # noqa: F401 — registration
from chimera_st_tpu_torch.config.registry import ARCHITECTURES, MODELS
from tests.test_torch_transformer import seeded_tree

TOL = 1e-4
V = 23
SRC = np.array([[5, 9, 11, 4, 7, 2, 1], [6, 3, 8, 12, 2, 1, 1]], np.int32)
PREV = np.array([[2, 5, 14, 3, 8], [2, 7, 10, 1, 1]], np.int32)


def jax_tree(tree, seed: int):
    """``seeded_tree``'s draws as JAX arrays, kernels at gain 1 (N(0,
    1 / fan_in)): the zoo's stacks have no LayerNorm, so the tree's gain 1.5
    grows the states layer by layer into peaked softmaxes."""
    def leaf(path, x):
        gain = 1 / 1.5 if jax.tree_util.keystr(path).endswith("['kernel']") else 1.0
        return jnp.asarray(x * gain)

    return jax.tree_util.tree_map_with_path(leaf, seeded_tree(tree, seed))


def port_model(name: str, cfg: dict):
    model_name, preset = ARCHITECTURES.get(name)
    model = MODELS.get(model_name)(preset(dict(cfg)), device="cpu")
    return model.eval()


def load(model, params, table: str):
    model.load_state_dict(convert.params_from_flax(params, table), strict=True)
    return model


def grads_to_flax(model, table: str):
    """The port's gradients in the flax tree (zero where the loss does not
    reach a parameter, as every leaf of a JAX gradient tree is)."""
    return convert.params_to_flax({n: torch.zeros_like(p) if p.grad is None else p.grad
                                   for n, p in model.named_parameters()}, table)


def assert_grads_match(jax_grads, port_grads):
    flat_j = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(jax_grads["params"])}
    flat_p = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(port_grads["params"])}
    assert flat_j.keys() == flat_p.keys()
    for k, want in flat_j.items():
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(flat_p[k], want, atol=TOL * scale, rtol=0, err_msg=k)


# XLA's backend optimisations off: a tiny model's gradient compiles in about
# half the time, and its fp32 arithmetic is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_params(jax_model, seed: int, *args, method=None):
    """Seeded weights (``jax_tree``) over the shapes of a flax init, which
    ``eval_shape`` traces without running it."""
    shapes = jax.eval_shape(functools.partial(jax_model.init, method=method),
                            jax.random.PRNGKey(0), *args)
    return jax_tree(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)


def jax_outputs_and_grads(jax_model, params, args, seed: int, method=None):
    """(outputs, gradients of sum(outputs * R)), R seeded, from one
    compiled function."""
    out_shape = jax.eval_shape(functools.partial(jax_model.apply, method=method), params, *args)
    r = jnp.asarray(np.random.default_rng(seed).normal(size=out_shape.shape), jnp.float32)

    def f(p, r, *a):
        y = jax_model.apply(p, *a, method=method)
        return jnp.sum(y * r), y

    fn = jax.jit(jax.grad(f, has_aux=True)).lower(params, r, *args).compile(
        compiler_options=FAST_COMPILE)
    grads, out = fn(params, r, *args)
    return np.asarray(out), grads, np.array(r)


def check_model(jax_model, jax_args, port, port_args, table: str, seed: int):
    """Logits and every gradient of sum(logits * R), R seeded."""
    params = jax_params(jax_model, seed, *jax_args)
    load(port, params, table)
    want, jg, r = jax_outputs_and_grads(jax_model, params, jax_args, seed)
    got = port(*port_args)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL * max(1.0, np.abs(want).max()),
                               rtol=0)
    (got * torch.from_numpy(r)).sum().backward()
    assert_grads_match(jg, grads_to_flax(port, table))


# case -> (arch, conversion table, tiny widths)
TINY = {
    "fconv": ("fconv", "fconv", dict(
        embed_dim=16, encoder_layers=((16, 3), (24, 3), (24, 2)),
        decoder_layers=((16, 3), (16, 2), (24, 1)), decoder_out_embed_dim=8, max_positions=32)),
    "fconv_self_att": ("fconv_self_att", "fconv_self_att", dict(
        embed_dim=16, encoder_layers=((16, 3), (24, 3)), decoder_layers=((16, 4), (24, 4)),
        decoder_out_embed_dim=8, self_attention_heads=2, downsample=2,
        encoder_attention=[True, False], max_positions=32)),
    "fconv_self_att_pretrained": ("fconv_self_att", "fconv_self_att", dict(
        embed_dim=16, encoder_layers=((16, 3),), decoder_layers=((16, 3), (16, 3)),
        decoder_out_embed_dim=8, pretrained_lm=True, max_positions=32)),
    "lightconv": ("lightconv", "lightconv", dict(
        embed_dim=16, ffn_dim=24, encoder_layers=2, decoder_layers=2, heads=4,
        encoder_kernel_sizes=(3, 4), decoder_kernel_sizes=(3, 5))),
    "dynamicconv": ("dynamicconv_iwslt_de_en", "lightconv", dict(
        embed_dim=16, ffn_dim=24, encoder_layers=2, decoder_layers=1, heads=2,
        normalize_before=False, share_decoder_input_output_embed=False)),
    "lstm": ("lstm", "lstm", dict(
        embed_dim=12, hidden_size=16, encoder_layers=2, decoder_layers=2, bidirectional=True)),
    "simple_lstm": ("simple_lstm", "lstm", dict(
        embed_dim=16, hidden_size=16, share_decoder_input_output_embed=True)),
}


def jax_model(arch: str, cfg: dict):
    model_name, preset = JAX_ARCHITECTURES.get(arch)
    return JAX_MODELS.get(model_name)(preset(dict(cfg)))


@dataclasses.dataclass(frozen=True)
class NarrowLM(jax_fconv.FConvLMConfig):
    """The nested LM of ``pretrained_lm`` at FConvLMConfig's defaults is 13
    layers of 1,268 channels (167 M parameters); both packages build it from
    this narrower config in the test."""
    embed_dim: int = 16
    layers: tuple = ((16, 3), (24, 2))
    out_embed_dim: int = 12


@pytest.mark.parametrize("name", sorted(TINY))
def test_teacher_forced_logits_and_gradients_match_jax(name, monkeypatch):
    monkeypatch.setattr(jax_fconv, "FConvLMConfig", NarrowLM)
    monkeypatch.setattr(fconv_self_att, "FConvLMConfig", NarrowLM)
    arch, table, widths = TINY[name]
    cfg = dict(widths, src_vocab_size=V, tgt_vocab_size=V, dropout=0.1)
    port = port_model(arch, cfg)
    assert convert.model_kind(port) == table
    check_model(jax_model(arch, cfg), (jnp.asarray(SRC), jnp.asarray(PREV)), port,
                (torch.from_numpy(SRC).long(), torch.from_numpy(PREV).long()), table,
                seed=sorted(TINY).index(name) + 40)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("K", [4, 5])
def test_shifted_views_and_conv_weights_match_jax(K, causal):
    """The views pad (K - 1) // 2 on the left and the rest on the right (or
    K - 1 on the left, causal); lightweight [H, K] and dynamic [B, T, H, K]
    weights contract them alike: exact for the views, 1e-5 for the sums."""
    rng = np.random.default_rng(K + 10 * causal)
    x = rng.normal(size=(2, 6, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        conv_attention.shifted_views(torch.from_numpy(x), K, causal).numpy(),
        np.asarray(jax_ca._shifted_views(jnp.asarray(x), K, causal)))
    for w in (rng.normal(size=(2, K)), rng.normal(size=(2, 6, 2, K))):
        w = w.astype(np.float32)
        np.testing.assert_allclose(
            conv_attention.apply_conv_weights(torch.from_numpy(x), torch.from_numpy(w), 2,
                                              causal).numpy(),
            np.asarray(jax_ca.apply_conv_weights(jnp.asarray(x), jnp.asarray(w), 2, causal)),
            atol=1e-5, rtol=1e-5)


def test_vgg_block_and_adaptive_input_match_jax():
    """VGGBlock (SAME convolutions, LayerNorm, max-pool) on [B, T, F, C] and
    AdaptiveInput over three clusters with a pad: 1e-5; the sparse mask is
    equal in both modes."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 8, 2)).astype(np.float32)
    jv = jax_mod.VGGBlock(4, conv_kernel_size=3, layer_norm=True)
    params = jax_params(jv, 5, jnp.asarray(x))
    port = modules_extra.VGGBlock(2, 4, 3, layer_norm=True, device="cpu")
    p = {k: {leaf: np.asarray(v) for leaf, v in d.items()} for k, d in params["params"].items()}
    sd = {}
    for i in range(2):  # flax NHWC kernels [kh, kw, in, out] -> [out, in, kh, kw]
        sd[f"conv.{i}.weight"] = torch.tensor(p[f"conv_{i}"]["kernel"].transpose(3, 2, 0, 1))
        sd[f"conv.{i}.bias"] = torch.tensor(p[f"conv_{i}"]["bias"])
        sd[f"ln.{i}.weight"] = torch.tensor(p[f"ln_{i}"]["scale"])
        sd[f"ln.{i}.bias"] = torch.tensor(p[f"ln_{i}"]["bias"])
    port.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax.jit(jv.apply)(params, jnp.asarray(x))), atol=1e-5,
                               rtol=1e-5)

    ids = np.array([[0, 3, 7, 12, 1], [11, 1, 5, 9, 2]], np.int32)
    ja = jax_mod.AdaptiveInput(13, 16, 8, factor=2.0, cutoff=(4, 9))
    params = jax_params(ja, 6, jnp.asarray(ids))["params"]
    pa = modules_extra.AdaptiveInput(13, 16, 8, factor=2.0, cutoff=(4, 9), device="cpu")
    pa.load_state_dict({**{f"embed.{i}.weight": torch.tensor(np.asarray(
        params[f"embed_{i}"]["embedding"])) for i in range(3)},
        **{f"proj.{i}.weight": torch.tensor(np.asarray(params[f"proj_{i}"]["kernel"]).T)
           for i in range(3)}}, strict=True)
    np.testing.assert_allclose(pa(torch.from_numpy(ids).long()).detach().numpy(),
                               np.asarray(jax.jit(ja.apply)({"params": params},
                                                            jnp.asarray(ids))),
                               atol=1e-5, rtol=1e-5)
    for bidirectional in (True, False):
        np.testing.assert_array_equal(
            modules_extra.sparse_attention_mask(70, 16, 4, bidirectional).numpy(),
            np.asarray(jax_mod.sparse_attention_mask(70, 16, 4, bidirectional)))


def test_reverse_recurrence_reads_the_pads_first_in_both_packages():
    """A JAX-package fault the port keeps (ROADMAP C): the encoder's
    reverse LSTM runs over the padded batch, so a sentence's states depend
    on how many pads follow it. The port's states match JAX's for the padded
    row and differ from the same row run alone."""
    cfg = dict(TINY["lstm"][2], src_vocab_size=V, tgt_vocab_size=V)
    jm = jax_model("lstm", cfg)
    params = jax_params(jm, 9, jnp.asarray(SRC), jnp.asarray(PREV))
    port = load(port_model("lstm", cfg), params, "lstm")
    padded, _ = port.encode_text(torch.from_numpy(SRC[1:]).long())
    alone, _ = port.encode_text(torch.from_numpy(SRC[1:, :5]).long())
    want, _ = jax.jit(lambda p, s: jm.apply(p, s, method=jm.encode_text))(params,
                                                                       jnp.asarray(SRC[1:]))
    np.testing.assert_allclose(padded.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert np.abs(padded[0, :5].detach().numpy() - alone[0].detach().numpy()).max() > 1e-3
