"""Parity of the port's wav2vec 2.0 speech recognition models with the JAX
package on the CPU: the trunk's span masking, layerdrop and ``layer_norm``
extractor mode, ``Wav2VecCtcModel`` with the ``ctc`` criterion (every row's
loss against ``optax.ctc_loss``, an infeasible row and eos targets
included) and the ``freeze_finetune_updates`` gate, ``Wav2VecSeq2SeqModel``
(logits and a beam decode), and the fairseq fine-tune importers.

Weights are made by flax and carried across with ``convert`` (the
``wav2vec_ctc`` / ``wav2vec_seq2seq`` tables); inputs come from numpy with
a fixed seed. Tolerances: 1e-4 absolute on activations and logits, 1e-5
relative on CTC losses, 1e-4 relative to each tensor's largest value on
gradients (fp32 through a few chained layers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chimera_st_tpu.checkpoint import torch_import as jax_import
from chimera_st_tpu.criterions.ctc import make_ctc_criterion as jax_ctc
from chimera_st_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxW2V2
from chimera_st_tpu.models.wav2vec2 import extractor_output_length
from chimera_st_tpu.models.wav2vec2_asr import Wav2VecAsrConfig as JaxCfg
from chimera_st_tpu.models.wav2vec2_asr import Wav2VecCtcModel as JaxCtc
from chimera_st_tpu.models.wav2vec2_asr import Wav2VecSeq2SeqModel as JaxS2S
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.checkpoint import torch_import
from chimera_st_tpu_torch.criterions.ctc import ctc_loss, make_ctc_criterion
from chimera_st_tpu_torch.models.wav2vec2 import Wav2Vec2Encoder, layerdrop_keep
from chimera_st_tpu_torch.models.wav2vec2_asr import (
    Wav2VecAsrConfig,
    Wav2VecCtcModel,
    Wav2VecSeq2SeqModel,
)

CONV = ((16, 3, 2), (16, 3, 2))
TINY = dict(vocab_size=12, w2v2_embed_dim=32, w2v2_ffn_dim=64, w2v2_layers=2, w2v2_heads=4,
            w2v2_conv_spec=CONV, w2v2_conv_pos=8, w2v2_conv_pos_groups=4,
            decoder_embed_dim=32, decoder_ffn_dim=64, decoder_layers=2, decoder_heads=4)
TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLES = 400
FRAMES = extractor_output_length(SAMPLES, CONV)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def audio(seed=0, pad_from=(None, 250)):
    rng = np.random.default_rng(seed)
    wav = rng.normal(size=(len(pad_from), SAMPLES)).astype(np.float32)
    mask = np.zeros(wav.shape, bool)
    for b, p in enumerate(pad_from):
        if p is not None:
            mask[b, p:] = True
    return wav, mask


def span_mask(seed=3):
    m = np.zeros((2, FRAMES), bool)
    rng = np.random.default_rng(seed)
    for b in range(2):
        s = int(rng.integers(0, FRAMES - 10))
        m[b, s: s + 10] = True
    return m


def assert_grads_close(port_model, jax_grads, kind, rel=1e-4):
    """Every gradient of the port's parameters against the JAX gradient
    tree, each within ``rel`` of the tensor's largest value plus 1e-6 (a
    key projection's bias has a gradient that is zero up to round-off)."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in port_model.named_parameters()}
    got = jax.tree_util.tree_leaves_with_path(convert.params_to_flax(grads, kind))
    want = dict(jax.tree_util.tree_leaves_with_path(np_tree(jax_grads)))
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(g, w, atol=rel * float(np.abs(w).max()) + 1e-6, rtol=0,
                                   err_msg=str(path))


# ------------------------------------------------------------------ trunk


TRUNK_CASES = {
    "default_unmasked": dict(mask=False, mode="default", bias=False),
    "default_masked": dict(mask=True, mode="default", bias=False),
    "layer_norm_conv_bias_masked": dict(mask=True, mode="layer_norm", bias=True),
}


@pytest.mark.parametrize("case", sorted(TRUNK_CASES))
def test_trunk_matches_jax(case):
    """The trunk in training mode (dropouts and layerdrop 0): the span mask
    swaps in ``mask_emb`` where given; the ``layer_norm`` extractor with
    conv bias."""
    c = TRUNK_CASES[case]
    kw = dict(encoder_embed_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=4,
              conv_spec=CONV, conv_pos=8, conv_pos_groups=4, conv_bias=c["bias"])
    jm = JaxW2V2(**kw, extractor_mode=c["mode"], mask_emb=c["mask"], dropout=0.0,
                 attention_dropout=0.0)
    wav, mask = audio()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask))
    mi = span_mask() if c["mask"] else None
    ref, ref_mask = jax.jit(lambda p, w, m, i: jm.apply(p, w, m, deterministic=False,
                                                        mask_indices=i))(
        params, jnp.asarray(wav), jnp.asarray(mask), None if mi is None else jnp.asarray(mi))
    model = Wav2Vec2Encoder(32, 64, 2, 4, CONV, c["bias"], conv_pos=8, conv_pos_groups=4,
                            extractor_mode=c["mode"], mask_emb=c["mask"], device="cpu")
    model.load_state_dict(convert.wav2vec2_params_from_flax(np_tree(params)), strict=True)
    got, got_mask = model.train()(torch.from_numpy(wav), torch.from_numpy(mask),
                                  mask_indices=None if mi is None else torch.from_numpy(mi))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    if c["mask"]:
        unmasked, _ = model(torch.from_numpy(wav), torch.from_numpy(mask))
        assert not torch.allclose(unmasked, got)


def test_layerdrop_rate_and_evaluation():
    """LayerDrop keeps each layer with probability 1 - rate (the decisions
    a host list keyed by the forward's generator: the same seed, the same
    layers), and evaluation runs every layer (the output of layerdrop 0)."""
    g = torch.Generator().manual_seed(5)
    keep = layerdrop_keep(20000, 0.3, g)
    assert abs(np.mean(keep) - 0.7) < 0.01
    assert keep == layerdrop_keep(20000, 0.3, torch.Generator().manual_seed(5))
    assert keep != layerdrop_keep(20000, 0.3, torch.Generator().manual_seed(6))
    with pytest.raises(ValueError, match="Generator"):
        layerdrop_keep(4, 0.3, None)
    model = Wav2Vec2Encoder(32, 64, 6, 4, CONV, conv_pos=8, conv_pos_groups=4,
                            layerdrop=0.5, device="cpu")
    from chimera_st_tpu_torch.models.interlingua import init_params_

    init_params_(model, torch.Generator().manual_seed(0))
    wav, mask = audio()
    args = (torch.from_numpy(wav), torch.from_numpy(mask))
    with torch.no_grad():
        full, _ = model.eval()(*args)
        model.layerdrop = 0.0
        model.train()
        no_drop, _ = model(*args, torch.Generator().manual_seed(1))
        model.layerdrop = 0.5
        dropped = [model(*args, torch.Generator().manual_seed(s))[0] for s in range(4)]
    torch.testing.assert_close(full, no_drop)
    assert any(not torch.allclose(d, full) for d in dropped)


# --------------------------------------------------------------------- CTC


@pytest.fixture(scope="module")
def ctc_models():
    cfg = dict(TINY, apply_mask=True, freeze_finetune_updates=2)
    jm = JaxCtc(JaxCfg(**cfg))
    wav, mask = audio()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(mask))
    model = Wav2VecCtcModel(Wav2VecAsrConfig(**cfg), device="cpu")
    model.load_state_dict(convert.params_from_flax(np_tree(params), "wav2vec_ctc"), strict=True)
    return jm, params, model


@functools.lru_cache(maxsize=None)
def jax_ctc_grad(jm, sentence_avg: bool):
    """The JAX ``ctc`` criterion's (loss, sample size) and gradients in
    training, jitted once for each model and ``sentence_avg``."""
    jcrit = jax_ctc({"padding_idx": 1, "sentence_avg": sentence_avg})

    def loss(p, batch, num_updates):
        out, ss, _ = jcrit(jm, p, batch, num_updates=num_updates, train=True)
        return out, ss

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def ctc_batch(short_row: bool):
    """Row 1 padded; with ``short_row`` so far that its 12 labels outnumber
    its frames (an infeasible alignment). Row 0 ends in eos, then pad."""
    wav, mask = audio(pad_from=(None, 40 if short_row else 250))
    target = np.array([[4, 5, 5, 6, 7, 2, 1, 1, 1, 1, 1, 1],
                       [4, 5, 6, 7, 8, 9, 10, 11, 4, 5, 6, 7]], np.int64)
    return {"audio": wav, "audio_padding_mask": mask, "target": target,
            "mask_indices": span_mask(), "ntokens": 17.0, "nsentences": 2}


@pytest.mark.parametrize("short_row", [False, True], ids=["feasible", "infeasible_row"])
@pytest.mark.parametrize("sentence_avg", [False, True])
def test_ctc_loss_and_gradients_match_jax(ctc_models, short_row, sentence_avg):
    """The ``ctc`` criterion in training (span mask given, past the freeze
    horizon): loss, sample size and every gradient as JAX's; an infeasible
    row costs about 1e5 in both (optax's log_epsilon), not inf. Its
    forward variables sit near -1e5, where fp32's spacing is 0.0078, so its
    gradients are held to 1e-3 of each tensor's largest value."""
    jm, params, model = ctc_models
    batch = ctc_batch(short_row)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    (ref_loss, ref_ss), ref_grads = jax_ctc_grad(jm, sentence_avg)(params, jb, jnp.asarray(5))
    crit = make_ctc_criterion({"padding_idx": 1, "sentence_avg": sentence_avg})
    model.train().zero_grad()
    tb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    loss, ss, logging = crit(model, tb, None, torch.tensor(5))
    loss.backward()
    assert float(ss) == float(ref_ss) == (2.0 if sentence_avg else 17.0)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    if short_row:
        assert 9e4 < float(loss.detach()) < 2e5
    assert_grads_close(model, ref_grads, "wav2vec_ctc", rel=1e-3 if short_row else 1e-4)


def test_ctc_loss_rows_equal_optax():
    """Each row of the plain recursion against ``optax.ctc_loss``: random
    logits, paddings and a repeated label, a row whose target is longer than
    its frames (optax gives about 1e5, ``F.ctc_loss`` inf) and a row with no
    labels."""
    rng = np.random.default_rng(2)
    B, T, K, N = 4, 9, 6, 7
    logits = rng.normal(size=(B, T, K)).astype(np.float32)
    lp = np.zeros((B, T), np.float32)
    lp[1, 6:] = 1.0
    lp[2, 3:] = 1.0
    labels = rng.integers(1, K, size=(B, N))
    labels[0, 1] = labels[0, 0]
    lab_pad = np.zeros((B, N), np.float32)
    lab_pad[0, 4:] = 1.0
    lab_pad[1, 3:] = 1.0
    lab_pad[3, :] = 1.0
    ref = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(lp),
                                    jnp.asarray(labels), jnp.asarray(lab_pad)))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(lp), torch.from_numpy(labels),
                   torch.from_numpy(lab_pad)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert ref[2] > 9e4  # 7 labels over 3 frames
    lens = torch.tensor([7, 6, 3, 9])
    torch_inf = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
        torch.from_numpy(labels), lens[[0, 1, 2, 3]].clamp(max=T),
        torch.tensor([4, 3, 7, 0]), reduction="none")
    assert torch.isinf(torch_inf[2])


@pytest.mark.parametrize("num_updates", [1, 2], ids=["frozen", "past_horizon"])
def test_freeze_finetune_updates_gate_matches_jax(ctc_models, num_updates):
    """Before update N (2) the trunk's output is detached: only ``proj``
    has a gradient; from N on the trunk trains. Both sides of N equal JAX."""
    jm, params, model = ctc_models
    batch = ctc_batch(False)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    _, ref_grads = jax_ctc_grad(jm, False)(params, jb, jnp.asarray(num_updates))
    crit = make_ctc_criterion({"padding_idx": 1})
    model.train().zero_grad()
    tb = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    crit(model, tb, None, torch.tensor(num_updates))[0].backward()
    trunk = [p.grad for n, p in model.named_parameters() if ".w2v_model." in n]
    frozen = all(g is None or not g.any() for g in trunk)
    assert frozen == (num_updates < 2)
    assert model.w2v_encoder.proj.weight.grad.abs().sum() > 0
    assert_grads_close(model, ref_grads, "wav2vec_ctc")


def test_ctc_logits_in_evaluation_ignore_the_span_mask(ctc_models):
    jm, params, model = ctc_models
    wav, mask = audio(1)
    ref, ref_mask = jm.apply(params, jnp.asarray(wav), jnp.asarray(mask),
                             mask_indices=jnp.asarray(span_mask()), method=JaxCtc.ctc_logits)
    with torch.no_grad():
        got, got_mask = model.eval().ctc_logits(torch.from_numpy(wav), torch.from_numpy(mask),
                                                mask_indices=torch.from_numpy(span_mask()))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------------- seq2seq


def test_seq2seq_logits_and_beam_decode_match_jax():
    """The decoder wider than the trunk (``encoder.proj``), the untied
    output: teacher-forced logits, and a beam-4 decode token-identical to
    the JAX generator's."""
    from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
    from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
    from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator

    cfg = dict(TINY, decoder_embed_dim=48, decoder_ffn_dim=96)
    jm = JaxS2S(JaxCfg(**cfg))
    wav, mask = audio(4)
    prev = np.array([[2, 4, 5, 6], [2, 7, 8, 1]])
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(wav), jnp.asarray(mask),
                              jnp.asarray(prev))
    model = Wav2VecSeq2SeqModel(Wav2VecAsrConfig(**cfg), device="cpu").eval()
    model.load_state_dict(convert.params_from_flax(np_tree(params), "wav2vec_seq2seq"),
                          strict=True)
    ref = jax.jit(jm.apply)(params, jnp.asarray(wav), jnp.asarray(mask), jnp.asarray(prev))
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(mask), torch.from_numpy(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    settings = dict(beam_size=4, max_decode_len=10, max_len_b=10)
    jt, js, jl = JaxGenerator(jm, JaxSettings(**settings), pad=1, eos=2, unk=3).generate_audio(
        params, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        pt, ps, pl = SequenceGenerator(model, GeneratorSettings(**settings), pad=1, eos=2,
                                       unk=3).generate_audio(torch.from_numpy(wav),
                                                             torch.from_numpy(mask))
    jl, pl = np.asarray(jl), pl.numpy()
    np.testing.assert_array_equal(pl[:, 0], jl[:, 0])
    for b in range(2):
        np.testing.assert_array_equal(pt.numpy()[b, 0, : pl[b, 0]],
                                      np.asarray(jt)[b, 0, : jl[b, 0]])
    np.testing.assert_allclose(ps.numpy()[:, 0], np.asarray(js)[:, 0], atol=1e-4)


# ----------------------------------------------------------------- importers


@pytest.mark.parametrize("apply_mask", [True, False], ids=["with_mask_emb", "without"])
@pytest.mark.parametrize("kind", ["wav2vec_ctc", "wav2vec_seq2seq"])
def test_fine_tune_importers_match_jax(kind, apply_mask):
    """A seeded fairseq fine-tune state dict (``tests/torch_reference.py``,
    saved and loaded as a ``.pt``) through each package's importer: the
    port's tensors equal the JAX tree's leaf for leaf, ``mask_emb`` kept or
    dropped, and the port's model loads it strictly."""
    from tests.torch_reference import TorchWav2VecCtc, TorchWav2VecSeq2Seq

    torch.manual_seed(3)
    if kind == "wav2vec_ctc":
        ref = TorchWav2VecCtc(CONV, 32, 64, 2, 4, vocab=12)
        importers = (jax_import.import_wav2vec_ctc_state_dict,
                     torch_import.import_wav2vec_ctc_state_dict)
        cfg = dict(TINY)
    else:
        ref = TorchWav2VecSeq2Seq(CONV, 32, 64, 2, 4, vocab=12, dec_d=48, dec_ffn=96,
                                  dec_layers=2, dec_heads=4)
        importers = (jax_import.import_wav2vec_seq2seq_state_dict,
                     torch_import.import_wav2vec_seq2seq_state_dict)
        cfg = dict(TINY, decoder_embed_dim=48, decoder_ffn_dim=96,
                   decoder_normalize_before=True)
    sd = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    want = importers[0](sd, apply_mask=apply_mask)
    got = importers[1](sd, apply_mask=apply_mask)
    back = convert.params_from_flax(np_tree(want), kind)
    assert sorted(back) == sorted(got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), back[k].numpy(), atol=1e-6, err_msg=k)
    assert any(k.endswith("mask_emb") for k in got) == apply_mask
    model_cls = Wav2VecCtcModel if kind == "wav2vec_ctc" else Wav2VecSeq2SeqModel
    model = model_cls(Wav2VecAsrConfig(**cfg, apply_mask=apply_mask), device="cpu")
    model.load_state_dict(got, strict=True)
    bad = dict(sd, **{"decoder.mystery.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="unmatched"):
        importers[1](bad)
