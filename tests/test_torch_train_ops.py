"""The training forms of the port's kernel wrappers and layers, on the CPU.

- K1 / K2 backward: ``encoder_attention_backward`` and ``conv_tail_backward``
  against ``jax.vjp`` of the Pallas wrappers ``fused_encoder_attention`` /
  ``fused_conv_tail`` (interpret mode, as tests/test_pallas_*.py run them),
  and ``EncoderAttentionFn`` / ``ConvTailFn`` routing gradients when their
  kernel entry is stood in for by the plain version (a CUDA kernel cannot
  run here; the card runs the real ones in ``chip_smoke.py``).
- The K1 gate: attention dropout in training takes the plain path.
- Dropout: the helper's keep rate and 1/(1-p) scaling, and every dropout
  site of the interlingua model (audio and text pass), each rate's sites
  counted and checked statistically; eval mode bit-identical to the
  inference path.

fp32 throughout; tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.ops.attention import dot_product_attention as jax_attention
from chimera_st_tpu.ops.pallas_attention import fused_encoder_attention
from chimera_st_tpu.ops.pallas_conv import fused_conv_tail
from chimera_st_tpu_torch.models import interlingua, layers, transformer_decoder, wav2vec2
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, init_params_
from chimera_st_tpu_torch.ops import attention, conv_tail, encoder_attention
from tests.test_interlingua_model import TINY
from tests.test_torch_models import padded_audio, port_config


def _attention_inputs(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = np.zeros((B, T), bool)
    mask[1, T // 2:] = True
    if B > 2:
        mask[2, :] = True  # fully padded: the backward is the plain version's gradient
    return q, k, v, g, mask


def _jax_vjp(fn, q, k, v, g):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("B,T,H,D", [(3, 19, 2, 64), (2, 70, 2, 96)])
def test_encoder_attention_backward_matches_jax_vjp(B, T, H, D):
    """dq, dk, dv vs jax.vjp of the Pallas wrapper (its custom_vjp backward)
    on every row that has a real key, vs jax.vjp of the XLA path
    (``dot_product_attention``) on all rows, the fully padded one included,
    and vs torch autograd through the plain version; 1e-5."""
    q, k, v, g, mask = _attention_inputs(0, B, T, H, D)
    pallas = _jax_vjp(lambda q, k, v: fused_encoder_attention(
        q, k, v, jnp.asarray(mask), float(D ** -0.5), interpret=True), q, k, v, g)
    xla = _jax_vjp(lambda q, k, v: jax_attention(q, k, v, key_padding_mask=jnp.asarray(mask)),
                   q, k, v, g)
    tq, tk, tv, tg, tm = (torch.from_numpy(x) for x in (q, k, v, g, mask))
    got = encoder_attention.encoder_attention_backward(tq, tk, tv, tm, tg)
    real = ~mask.all(axis=1)
    for name, a, b, c in zip("qkv", got, pallas, xla):
        np.testing.assert_allclose(a.numpy()[real], b[real], atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(a.numpy(), c, atol=1e-5, rtol=1e-5, err_msg=f"d{name} vs XLA")
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    encoder_attention.encoder_attention_plain(*leaves, tm).backward(tg)
    for name, a, leaf in zip("qkv", got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"autograd d{name}")


def test_encoder_attention_fn_routes_gradients(monkeypatch):
    """EncoderAttentionFn: forward through the kernel entry (here the plain
    version standing in, counted), backward through the recompute; grads
    equal autograd of the plain version (1e-6) and the mask gets none."""
    calls = []

    def stand_in(q, k, v, key_padding_mask=None):
        calls.append(q.shape)
        return encoder_attention.encoder_attention_plain(q, k, v, key_padding_mask)

    monkeypatch.setattr(encoder_attention, "encoder_attention_cuda", stand_in)
    q, k, v, g, mask = (torch.from_numpy(x) for x in _attention_inputs(1, 3, 21, 2, 64))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = encoder_attention.EncoderAttentionFn.apply(*leaves, mask)
    out.backward(g)
    assert calls == [(3, 21, 2, 64)] and out.grad_fn is not None
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.testing.assert_close(out, encoder_attention.encoder_attention_plain(*ref, mask))
    encoder_attention.encoder_attention_plain(*ref, mask).backward(g)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)


def _tail_inputs(seed, B, T1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T1, conv_tail.CH)).astype(np.float32)
    ws = [(rng.normal(size=(conv_tail.CH, conv_tail.CH, k)) * (2.0 / (k * conv_tail.CH)) ** 0.5)
          .astype(np.float32) for k, _ in conv_tail.TAIL_SPEC]
    return x, ws


def test_conv_tail_backward_matches_jax_vjp():
    """dx and the six dW vs jax.vjp of ``fused_conv_tail`` (interpret
    mode); weights [C_out, C_in, k] here, [k, C_in, C_out] there. B 2,
    T1 159 -> 2 output frames; 1e-5 relative to each gradient's max."""
    x, ws = _tail_inputs(2, 2, 159)
    rng = np.random.default_rng(3)
    y_ref, vjp = jax.vjp(lambda x, *w: fused_conv_tail(x, w, interpret=True),
                         jnp.asarray(x), *[jnp.asarray(w.transpose(2, 1, 0)) for w in ws])
    g = rng.normal(size=y_ref.shape).astype(np.float32)
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = conv_tail.conv_tail_backward(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                       torch.from_numpy(g))
    assert len(got) == 7
    pairs = [(got[0].numpy(), ref[0])] + [(a.numpy().transpose(2, 1, 0), b)
                                          for a, b in zip(got[1:], ref[1:])]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=0, err_msg=f"grad {i}")


def test_conv_tail_fn_routes_gradients_and_casts_weights(monkeypatch):
    """ConvTailFn: the kernel entry gets the weights in x's dtype and is
    launched once; the backward recomputes the plain tail and gives x and
    every weight its gradient (equal to autograd of the plain tail, 1e-6)."""
    seen = []

    def stand_in(x, weights):
        seen.append([w.dtype for w in weights])
        return conv_tail.conv_tail_plain(x, weights)

    monkeypatch.setattr(conv_tail, "conv_tail_cuda", stand_in)
    x, ws = _tail_inputs(4, 2, 100)
    x = torch.from_numpy(x).double()  # x in float64, weights float32: cast inside
    leaves = [x.clone().requires_grad_()] + [torch.from_numpy(w).requires_grad_() for w in ws]
    out = conv_tail.ConvTailFn.apply(*leaves)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=out.shape))
    out.backward(g)
    assert seen == [[torch.float64] * 6]
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    conv_tail.conv_tail_plain(ref[0], [w.double() for w in ref[1:]]).backward(g)
    for a, b in zip(leaves, ref):
        assert a.grad.dtype == a.dtype
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)


def test_encoder_attention_gate():
    q = torch.zeros(2, 5, 2, 64)
    gate = encoder_attention.encoder_attention_applicable
    assert gate(q, q)
    assert not gate(q, q, dropout_rate=0.1)
    assert not gate(q, q, causal=True)
    assert not gate(q, torch.zeros(2, 7, 2, 64))


@pytest.mark.parametrize("training,rate,k1", [(False, 0.1, True), (True, 0.0, True),
                                               (True, 0.1, False)])
def test_self_attention_takes_k1_only_without_dropout(monkeypatch, training, rate, k1):
    """MultiheadAttention runs K1 unless attention dropout is live (the JAX
    package's gate: its Pallas kernel has no dropout)."""
    used = []
    real = layers.encoder_attention
    monkeypatch.setattr(layers, "encoder_attention", lambda *a: used.append(1) or real(*a))
    mha = layers.MultiheadAttention(16, 2, dropout=rate, device="cpu").train(training)
    mha(torch.ones(2, 6, 16), generator=torch.Generator().manual_seed(0))
    assert bool(used) == k1


def test_dropout_helper_statistics():
    """Keep rate within 5 binomial sigmas of 1 - p, kept values x / (1 - p)
    exactly, the same generator seed the same mask, p 0 the identity, and no
    generator in training raises."""
    x = torch.rand(200_000) + 0.5
    for p in (0.1, 0.3):
        y = attention.dropout(x, p, torch.Generator().manual_seed(1))
        keep = y != 0
        n = x.numel()
        assert abs(keep.float().mean().item() - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
        assert torch.equal(y[keep], x[keep] / (1 - p))
        assert torch.equal(y, attention.dropout(x, p, torch.Generator().manual_seed(1)))
    assert attention.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        attention.dropout(x, 0.1, None)


RATES = dict(dropout=0.11, attention_dropout=0.13, activation_dropout=0.17, w2v2_dropout=0.19,
             w2v2_attention_dropout=0.23, w2v2_activation_dropout=0.29)


def _site_counts(c, audio: bool):
    """Dropout calls of one pass per rate, from the JAX modules' sites:
    trunk input x2 and per layer after attention and fc2; shared encoder
    embedding and per layer two; interlingua layers two each; decoder
    embedding and per layer three; one attention-probability and one
    activation dropout per attention / FFN block."""
    n = {
        "dropout": 2 + 2 * c.encoder_layers + 2 * c.interlingua_layers + 3 * c.decoder_layers,
        "attention_dropout": c.encoder_layers + c.interlingua_layers + 2 * c.decoder_layers,
        "activation_dropout": c.encoder_layers + c.interlingua_layers + c.decoder_layers,
    }
    if audio:
        n.update(w2v2_dropout=2 + 2 * c.w2v2_layers, w2v2_attention_dropout=c.w2v2_layers,
                 w2v2_activation_dropout=c.w2v2_layers)
    return n


@pytest.fixture(scope="module")
def dropout_model():
    cfg = port_config(dataclasses.replace(TINY, **RATES))
    return cfg, init_params_(ChimeraInterlinguaModel(cfg, device="cpu"),
                             torch.Generator().manual_seed(3))


def _inputs():
    wav, mask = padded_audio(2, batch=2, samples=4000)
    prev = torch.tensor([[2, 5, 6, 7, 8, 9], [2, 8, 9, 10, 1, 1]])
    src = torch.tensor([[4, 5, 6, 7, 2], [7, 8, 2, 1, 1]])
    return torch.from_numpy(wav), torch.from_numpy(mask), prev, src


def test_every_dropout_site_in_training(monkeypatch, dropout_model):
    """Training forward of the audio and the text pass with six distinct
    rates: each rate acts at the JAX model's number of sites, and pooled
    over its sites the keep rate (over nonzero inputs) lies within 5
    binomial sigmas of 1 - p; at every site the kept values are x / (1 - p)
    and the rest 0."""
    cfg, model = dropout_model
    calls = []
    real = attention.dropout

    def recording(x, p, generator):
        y = real(x, p, generator)
        if p > 0:
            calls.append((p, x.detach(), y.detach()))
        return y

    for mod in (attention, layers, wav2vec2, transformer_decoder, interlingua):
        monkeypatch.setattr(mod, "dropout", recording)
    wav, mask, prev, src = _inputs()
    gen = torch.Generator().manual_seed(0)
    model.train()
    for audio in (True, False):
        calls.clear()
        if audio:
            model.forward_audio_with_internal(wav, mask, prev, gen)
        else:
            model.forward_text_with_internal(src, prev, gen)
        by_rate = {name: [c for c in calls if c[0] == p] for name, p in RATES.items()}
        counts = {name: len(v) for name, v in by_rate.items() if v}
        assert counts == _site_counts(cfg, audio), audio
        for name in counts:
            p, sites = RATES[name], by_rate[name]
            kept = total = 0
            for _, x, y in sites:
                nz = x != 0
                keep = y != 0
                assert not (keep & ~nz).any()
                assert torch.equal(y[keep], x[keep] / (1 - p)), name
                kept += int((keep & nz).sum())
                total += int(nz.sum())
            assert total > 0 and abs(kept / total - (1 - p)) < 5 * (p * (1 - p) / total) ** 0.5, \
                (name, kept / total, total)


def test_eval_mode_is_the_inference_path(dropout_model):
    """With every rate on, eval mode is bit-identical to the inference path
    (encode_audio + decode under inference_mode), and training mode with
    every rate 0 equals eval mode bit for bit."""
    cfg, model = dropout_model
    wav, mask, prev, _ = _inputs()
    model.eval()
    with torch.inference_mode():
        enc, enc_mask = model.encode_audio(wav, mask)
        want = model.decode(prev, enc, enc_mask)
    got, mem = model.forward_audio_with_internal(wav, mask, prev, torch.Generator())
    assert torch.equal(got, want) and torch.equal(mem, enc)
    zero = ChimeraInterlinguaModel(
        dataclasses.replace(cfg, **{k: 0.0 for k in RATES}), device="cpu")
    zero.load_state_dict(model.state_dict())
    assert torch.equal(zero.train().forward_audio_with_internal(wav, mask, prev)[0], want)
