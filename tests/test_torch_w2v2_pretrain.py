"""Parity of the port's wav2vec pre-training with the JAX package on the
CPU: the Gumbel quantizer in training (the same uniform noise handed to
both) and the k-means quantizer, the pre-training outputs, the InfoNCE
reduction and the three criterions' losses and gradients (``wav2vec``,
``wav2vec_bimodal``, ``aligning_loss_bimodal``; both quantizers), wav2vec v1
with its criterion, and the raw-audio, labelled and bimodal datasets'
batches, array-equal to JAX's over two epochs of the task's iterator.

The criterions run in evaluation mode: the JAX pre-training trunk keeps
attention dropout 0.1 in training, whose ``jax.random`` bits the port
cannot draw. Tolerances: 1e-4 absolute on outputs, 1e-5 relative on
losses, 1e-4 of each tensor's largest value (plus 1e-6) on gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.criterions import wav2vec_pretraining as jax_crit
from chimera_st_tpu.models import wav2vec2_pretraining as J
from chimera_st_tpu.models import wav2vec_v1 as JV1
from chimera_st_tpu.models.wav2vec2 import extractor_output_length
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.config.registry import CRITERIONS
from chimera_st_tpu_torch.criterions import wav2vec_pretraining as port_crit
from chimera_st_tpu_torch.models import wav2vec2_pretraining as P
from chimera_st_tpu_torch.models import wav2vec_v1 as PV1

CONV = ((16, 3, 2), (16, 3, 2))
B, SAMPLES, NEG = 2, 400, 5
FRAMES = extractor_output_length(SAMPLES, CONV)
TOL = dict(atol=1e-4, rtol=1e-4)


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def model_kw(quantizer):
    return dict(encoder_embed_dim=32, encoder_ffn_dim=64, encoder_layers=2, encoder_heads=4,
                conv_spec=CONV, final_dim=16, latent_vars=10, latent_groups=2,
                num_negatives=NEG, conv_pos=8, conv_pos_groups=4, quantizer_type=quantizer)


def pretrain_batch(seed=0):
    rng = np.random.default_rng(seed)
    wav = rng.normal(size=(B, SAMPLES)).astype(np.float32)
    wav2 = rng.normal(size=(B, SAMPLES)).astype(np.float32)
    mask = J.compute_mask_indices((B, FRAMES), None, 0.5, 3, rng=rng)
    negs = J.sample_negative_indices(B, FRAMES, NEG, rng=rng)
    negs[0, :, 1] = np.arange(FRAMES)  # a negative that is the positive itself
    return {"audio": wav, "audio2": wav2, "audio_padding_mask": None,
            "audio2_padding_mask": None, "mask_indices": mask, "negative_indices": negs,
            "ntokens": float(mask.sum()), "nsentences": B}


@pytest.fixture(scope="module")
def models(request):
    kw = model_kw(request.param)
    jm = J.Wav2Vec2PretrainModel(J.W2V2PretrainConfig(**kw))
    b = pretrain_batch()
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                              jnp.asarray(b["audio"]), None, jnp.asarray(b["mask_indices"]),
                              jnp.asarray(b["negative_indices"]))
    model = P.Wav2Vec2PretrainModel(P.W2V2PretrainConfig(**kw), device="cpu")
    model.load_state_dict(convert.params_from_flax(np_tree(params), "wav2vec2_pretrain"),
                          strict=True)
    return request.param, jm, params, model


def to_torch(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def assert_grads_close(model, jax_grads, kind="wav2vec2_pretrain"):
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    got = jax.tree_util.tree_leaves_with_path(convert.params_to_flax(grads, kind))
    want = dict(jax.tree_util.tree_leaves_with_path(np_tree(jax_grads)))
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()) + 1e-6, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("models", ["gumbel", "kmeans"], indirect=True)
def test_pretrain_outputs_match_jax(models):
    """Logits over (positive, negatives) with -inf where a negative equals
    the positive, the valid mask, perplexity, the feature penalty and the
    k-means loss; converter round trip of every leaf."""
    name, jm, params, model = models
    b = pretrain_batch(1)
    ref = jax.jit(lambda p, a, m, n: jm.apply(p, a, None, m, n, deterministic=True))(
        params, jnp.asarray(b["audio"]), jnp.asarray(b["mask_indices"]),
        jnp.asarray(b["negative_indices"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(b["audio"]), None,
                           torch.from_numpy(b["mask_indices"]),
                           torch.from_numpy(b["negative_indices"]))
    logits, want = got["logits"].numpy(), np.asarray(ref["logits"])
    np.testing.assert_array_equal(np.isinf(logits), np.isinf(want))
    # (other negatives whose quantized codes equal the positive's are -inf too)
    assert np.isinf(want[0, :, 2]).all() and not np.isinf(want[:, :, 0]).any()
    np.testing.assert_allclose(np.where(np.isinf(want), 0, logits),
                               np.where(np.isinf(want), 0, want), **TOL)
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))
    for k in ("prob_perplexity", "features_pen", "kmeans_loss"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, atol=1e-6)
    assert got["num_vars"] == int(ref["num_vars"])
    back = convert.params_to_flax(model.state_dict(), "wav2vec2_pretrain")
    for (path, a), (_, w) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(np_tree(params))):
        np.testing.assert_array_equal(a, w, err_msg=str(path))


CRITERION_CASES = {
    "wav2vec": {"_name": "wav2vec"},
    "wav2vec_bimodal": {"_name": "wav2vec_bimodal"},
    "aligning_cosine": {"_name": "aligning_loss_bimodal", "loss": "cosine"},
    "aligning_l2_fix_text": {"_name": "aligning_loss_bimodal", "loss": "l2", "fix_side": "text"},
}
JAX_CRITERIONS = {"wav2vec": jax_crit.make_wav2vec_criterion,
                  "wav2vec_bimodal": jax_crit.make_wav2vec_bimodal_criterion,
                  "aligning_loss_bimodal": jax_crit.make_aligning_loss_bimodal}


# the k-means quantizer under ``wav2vec`` alone: the other criterions run
# the same quantizer code, or none (aligning)
@pytest.mark.parametrize("models, case", [("gumbel", c) for c in sorted(CRITERION_CASES)]
                         + [("kmeans", "wav2vec")], indirect=["models"])
def test_criterion_loss_and_gradients_match_jax(models, case):
    """Each criterion's loss, sample size, logged values and every gradient
    (evaluation mode: argmax quantizer, no dropout)."""
    _, jm, params, model = models
    cfg = CRITERION_CASES[case]
    b = pretrain_batch(2)
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}
    jcrit = JAX_CRITERIONS[cfg["_name"]](cfg)

    def jloss(p):
        loss, ss, logging = jcrit(jm, p, jb, train=False)
        return loss, (ss, logging)

    (ref_loss, (ref_ss, ref_log)), ref_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    model.eval().zero_grad()
    loss, ss, logging = CRITERIONS.get(cfg["_name"])(cfg)(model, to_torch(b), None, None)
    loss.backward()
    assert isinstance(ss, float)  # known on the host: no read of the device
    np.testing.assert_allclose(ss, float(ref_ss), rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    assert sorted(logging) == sorted(ref_log)
    for k, v in ref_log.items():
        np.testing.assert_allclose(float(torch.as_tensor(logging[k]).detach()), float(v),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert_grads_close(model, ref_grads)


def test_infonce_from_outputs_matches_jax():
    """The reduction alone, with a third (k-means) weight and -inf logits."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 7, 4)).astype(np.float32)
    logits[0, :, 2] = -np.inf
    mask = rng.random((2, 7)) < 0.5
    out = {"logits": logits, "mask": mask, "prob_perplexity": np.float32(7.5), "num_vars": 20,
           "features_pen": np.float32(0.3), "kmeans_loss": np.float32(0.02)}
    ref = jax_crit.infonce_from_outputs(
        {k: jnp.asarray(v) for k, v in out.items()}, (0.1, 10.0, 2.0))
    got = port_crit.infonce_from_outputs(
        {k: torch.as_tensor(v) if not isinstance(v, int) else v for k, v in out.items()},
        (0.1, 10.0, 2.0))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    for k, v in ref[2].items():
        np.testing.assert_allclose(float(got[2][k]), float(v), rtol=1e-6, err_msg=k)


def test_gumbel_quantizer_in_training_with_given_noise():
    """The straight-through Gumbel quantizer in training, the uniform noise
    drawn with ``jax.random.uniform`` on the JAX side and handed to the
    port: codes, perplexity and the gradients of input, codebook and
    projection."""
    jq = J.GumbelVectorQuantizer(16, num_vars=10, groups=2, vq_dim=16)
    x = np.random.default_rng(5).normal(size=(2, 9, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    params = jax.jit(lambda k, xx: jq.init(k, xx, train=False))(jax.random.PRNGKey(0),
                                                                jnp.asarray(x))
    noise = np.asarray(jax.random.uniform(key, (2 * 9 * 2, 10)))

    def jf(p, xx):
        out = jq.apply(p, xx, temperature=2.0, train=True, rng=key)
        return (out["x"] ** 2).sum() + out["prob_perplexity"], out

    (ref, ref_out), (gp, gx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    q = P.GumbelVectorQuantizer(16, 10, 2, 16, device="cpu").train()
    with torch.no_grad():
        q.codebook.copy_(torch.from_numpy(np.asarray(params["params"]["codebook"])))
        q.weight_proj.weight.copy_(torch.from_numpy(
            np.asarray(params["params"]["weight_proj"]["kernel"]).T))
        q.weight_proj.bias.copy_(torch.from_numpy(
            np.asarray(params["params"]["weight_proj"]["bias"])))
    xt = torch.from_numpy(x).requires_grad_()
    real = P.uniform_noise
    P.uniform_noise = lambda shape, generator, device: torch.from_numpy(noise)
    try:
        out = q(xt, 2.0, None)
    finally:
        P.uniform_noise = real
    loss = (out["x"] ** 2).sum() + out["prob_perplexity"]
    loss.backward()
    np.testing.assert_allclose(out["x"].detach().numpy(), np.asarray(ref_out["x"]), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(q.codebook.grad.numpy(), np.asarray(gp["params"]["codebook"]),
                               atol=1e-4)
    np.testing.assert_allclose(q.weight_proj.weight.grad.numpy().T,
                               np.asarray(gp["params"]["weight_proj"]["kernel"]), atol=1e-4)
    with pytest.raises(ValueError, match="Generator"):
        q(xt, 2.0, None)


def test_wav2vec_v1_and_its_criterion_match_jax():
    kw = {"conv_feature_layers": ((8, 10, 5), (8, 4, 2)),
          "conv_aggregator_layers": ((8, 3, 1), (8, 3, 1)), "prediction_steps": 3,
          "num_negatives": 4}
    jm = JV1.build_wav2vec_v1(kw)
    rng = np.random.default_rng(1)
    wav = rng.normal(size=(2, 400)).astype(np.float32)
    z_len = PV1.feature_length(400, PV1.Wav2VecV1Config(**kw))
    negs = rng.integers(0, z_len, size=(2, z_len, 4)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(negs))
    jcrit = JV1.make_wav2vec_v1_criterion({})
    jb = {"audio": jnp.asarray(wav), "negative_indices": jnp.asarray(negs)}
    (ref, ref_ss), grads = jax.jit(jax.value_and_grad(
        lambda p: jcrit(jm, p, jb, train=False)[:2], has_aux=True))(params)
    model = PV1.build_wav2vec_v1(kw, device="cpu")
    model.load_state_dict(convert.params_from_flax(np_tree(params), "wav2vec"), strict=True)
    loss, ss, _ = CRITERIONS.get("wav2vec_v1")({})(
        model, {"audio": torch.from_numpy(wav), "negative_indices": torch.from_numpy(negs)})
    loss.backward()
    assert ss == float(ref_ss) == 2 * 3 * z_len
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    assert_grads_close(model, grads, "wav2vec")


# ------------------------------------------------------------------ datasets


def write_audio_dir(root, n=7, labels=False, bimodal=False, seed=8):
    """Seeded wavs of 700-1,300 samples, a manifest (and a second aligned
    stream, or letter labels with ``dict.ltr.txt``) under ``root``."""
    from chimera_st_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    rows, lines = [], []
    letters = "abcdefghijklmnopqrstuvwxyz'"
    for i in range(n):
        k = int(rng.integers(700, 1300))
        write_wav(str(root / f"a{i}.wav"), (rng.normal(size=k) * 0.1).astype(np.float32))
        row = f"a{i}.wav\t{k}"
        if bimodal:
            k2 = k + int(rng.integers(-50, 50))
            write_wav(str(root / f"b{i}.wav"), (rng.normal(size=k2) * 0.1).astype(np.float32))
            row += f"\tb{i}.wav\t{k2}"
        rows.append(row)
        words = ["".join(rng.choice(list(letters), size=int(rng.integers(1, 5))))
                 for _ in range(int(rng.integers(1, 4)))]
        lines.append(" | ".join(" ".join(w) for w in words) + " |")
    header = "audio\tn_frames" + ("\taudio2\tn_frames2" if bimodal else "")
    for split in ("train", "valid"):
        (root / f"{split}.tsv").write_text(header + "\n" + "\n".join(rows) + "\n")
        if labels:
            (root / f"{split}.ltr").write_text("\n".join(lines) + "\n")
    if labels:
        (root / "dict.ltr.txt").write_text("".join(f"{c} 1\n" for c in "|" + letters))
    return root


DATASET_CASES = {
    "raw_audio": dict(task="audio_pretraining"),
    "labelled": dict(task="audio_pretraining", labels="ltr"),
    "labelled_autoregressive": dict(task="audio_pretraining", labels="ltr", autoregressive=True),
    "bimodal": dict(task="bimodal_pretraining"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_batches_array_equal_to_jax_over_two_epochs(tmp_path, case):
    """The task's shuffled batch iterator, two epochs: every array of every
    batch equal to the JAX package's (crops, span masks, negatives, labels,
    the eos-rotated decoder input); the dataset's numpy stream is seeded 1
    in both, whatever --seed says."""
    from chimera_st_tpu.tasks import setup_task as jax_setup
    from chimera_st_tpu_torch.tasks import setup_task

    c = dict(DATASET_CASES[case])
    write_audio_dir(tmp_path, labels="labels" in c, bimodal=c["task"] == "bimodal_pretraining")
    cfg = {"_name": c.pop("task"), "data": str(tmp_path), "min_sample_size": 600,
           "max_sample_size": 1000, "mask_prob": 0.4, "mask_length": 3, "num_negatives": 3,
           "conv_spec": CONV, **c}
    batches = []
    for setup in (jax_setup, setup_task):
        task = setup(dict(cfg))
        task.load_dataset("train")
        itr = task.make_batch_iterator(task.dataset("train"), max_tokens=2500, seed=3)
        got = []
        for _ in range(2):
            got += list(itr.next_epoch_itr(shuffle=True))
        batches.append(got)
    assert len(batches[0]) == len(batches[1]) > 2
    for want, got in zip(*batches):
        assert sorted(want) == sorted(got)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k


def test_the_collaters_draw_from_one_shared_stream_in_both_packages(tmp_path):
    """The same items collated twice give other crops and negatives: the
    collater is not a function of its items (one numpy stream a dataset),
    so a multi-worker prefetcher's batches depend on the order its threads
    draw (``--num-workers`` above 1, ROADMAP C)."""
    from chimera_st_tpu.data.raw_audio_dataset import RawAudioDataset as JaxRaw
    from chimera_st_tpu_torch.data.raw_audio_dataset import RawAudioDataset
    from chimera_st_tpu_torch.data.manifests import load_tsv

    write_audio_dir(tmp_path, n=3)
    rows = load_tsv(str(tmp_path / "train.tsv"))
    kw = dict(audio_root=str(tmp_path), max_sample_size=1000, min_sample_size=600,
              mask_prob=0.5, mask_length=3, num_negatives=3, frames_fn=lambda n: n // 10)
    for cls in (JaxRaw, RawAudioDataset):
        ds = cls(rows, **kw)
        items = [ds[i] for i in range(3)]
        a, b = ds.collater(items), ds.collater(items)
        assert not np.array_equal(a["negative_indices"], b["negative_indices"])
        assert not np.array_equal(a["audio"], b["audio"])  # the crop offsets too


def test_configs_keep_the_jax_defaults():
    """The trunks' heads default to 8 (fairseq's base has 12) and the
    Gumbel temperature of a batch without ``gumbel_temp`` is 2.0, as in
    JAX (ROADMAP C)."""
    from chimera_st_tpu.models.wav2vec2_asr import Wav2VecAsrConfig as JaxAsr
    from chimera_st_tpu_torch.models.wav2vec2_asr import Wav2VecAsrConfig

    assert Wav2VecAsrConfig().w2v2_heads == JaxAsr().w2v2_heads == 8
    assert P.W2V2PretrainConfig().encoder_heads == J.W2V2PretrainConfig().encoder_heads == 8
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, *args, gumbel_temp, generator=None):
            seen.append(gumbel_temp)
            raise StopIteration

    with pytest.raises(StopIteration):
        CRITERIONS.get("wav2vec")({})(Probe(), to_torch(pretrain_batch()), None, None)
    assert seen == [2.0]
