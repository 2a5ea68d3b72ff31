"""The port's feature transforms (``data/feature_transforms.py``) and the
fbank model served on precomputed features, against the JAX package, on the
CPU.

Each transform with ``np.random`` seeded the same gives the JAX transform's
array exactly; a data directory of .npy and zip-packed features whose config
names ``utterance_cmvn`` for ``'*'`` and ``specaugment`` + ``utterance_cmvn``
for ``_train`` (parameters at the top level of the config, as the
reference's ``gen_config_yaml`` writes them) gives the JAX dataset's
examples; and the port's generate CLI on it gives the JAX generator's
tokens."""

import json
import zipfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chimera_st_tpu.checkpoint.store import save_state
from chimera_st_tpu.data import feature_transforms as jax_ft
from chimera_st_tpu.data.manifests import S2TDataConfig as JaxDataConfig
from chimera_st_tpu.data.manifests import make_dataset_from_tsv as jax_dataset
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch.cli import generate
from chimera_st_tpu_torch.data import feature_transforms as ft
from chimera_st_tpu_torch.data.dictionary import Dictionary
from chimera_st_tpu_torch.data.manifests import S2TDataConfig, make_dataset_from_tsv

WORDS = ["the", "dog", "cat", "house", "tree", "car", "a", "runs"]
CONFIG = {
    "input_feat_per_channel": 80, "use_audio_input": False, "vocab_filename": "dict.txt",
    "transforms": {"*": ["utterance_cmvn"], "_train": ["specaugment", "utterance_cmvn"]},
    "specaugment": {"freq_mask_N": 2, "freq_mask_F": 9, "time_mask_N": 2, "time_mask_T": 12,
                    "time_mask_p": 0.5, "time_warp_W": 3},
    "utterance_cmvn": {"norm_means": True, "norm_vars": True},
}


def _features(rng, frames):
    return (rng.normal(size=(frames, 80)) * 3.0 + rng.normal(size=80) * 5.0).astype(np.float32)


@pytest.fixture(scope="module")
def fbank_dir(tmp_path_factory):
    """8 utterances of 40-160 frames: 4 as .npy files, 4 zip-packed (stored
    members addressed by byte offset and length)."""
    root = tmp_path_factory.mktemp("fbank")
    (root / "feats").mkdir()
    rng = np.random.default_rng(4)
    feats = [_features(rng, int(n)) for n in rng.integers(40, 160, size=8)]
    with zipfile.ZipFile(root / "feats.zip", "w", zipfile.ZIP_STORED) as z:
        for i in range(4, 8):
            with z.open(f"u{i}.npy", "w") as f:
                np.save(f, feats[i])
    audio = {}
    with zipfile.ZipFile(root / "feats.zip") as z:
        for info in z.infolist():
            offset = info.header_offset + 30 + len(info.filename.encode()) + len(info.extra)
            audio[int(info.filename[1])] = f"feats.zip:{offset}:{info.file_size}"
    for i in range(4):
        np.save(root / "feats" / f"u{i}.npy", feats[i])
        audio[i] = f"feats/u{i}.npy"
    rows = ["id\taudio\tn_frames\ttgt_text\tspeaker"]
    for i, f in enumerate(feats):
        tgt = " ".join(rng.choice(WORDS, size=rng.integers(2, 5)))
        rows.append(f"u{i}\t{audio[i]}\t{len(f)}\t{tgt}\tspk")
    for split in ("train", "test"):
        (root / f"{split}.tsv").write_text("\n".join(rows) + "\n")
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    (root / "config_wave.yaml").write_text(json.dumps({**CONFIG, "audio_root": str(root)}))
    return root, feats


def test_registry_matches_jax():
    assert sorted(ft.FEATURE_TRANSFORMS) == sorted(jax_ft.FEATURE_TRANSFORMS.keys())


SPEC_CASES = {
    "defaults": {},
    "masks": {"freq_mask_N": 3, "freq_mask_F": 20, "time_mask_N": 3, "time_mask_T": 30},
    "time_mask_p": {"time_mask_T": 100, "time_mask_p": 0.2},
    "time_warp": {"time_warp_W": 5, "time_mask_N": 0, "freq_mask_N": 0},
    "everything": {"time_warp_W": 4, "freq_mask_N": 2, "freq_mask_F": 15, "time_mask_N": 2,
                   "time_mask_T": 25, "time_mask_p": 0.7},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_specaugment_equals_jax(case):
    rng = np.random.default_rng(1)
    for frames in (9, 64, 150):
        x = _features(rng, frames)
        got, want = [], []
        for module, out in ((ft, got), (jax_ft, want)):
            t = module.SpecAugmentTransform.from_config_dict(SPEC_CASES[case])
            np.random.seed(frames)
            out.extend(t(x) for _ in range(3))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("means,variances", [(True, True), (True, False), (False, True)])
def test_utterance_cmvn_equals_jax(means, variances):
    x = _features(np.random.default_rng(2), 70)
    cfg = {"norm_means": means, "norm_vars": variances}
    np.testing.assert_array_equal(ft.UtteranceCMVN.from_config_dict(cfg)(x),
                                  jax_ft.UtteranceCMVN.from_config_dict(cfg)(x))


def test_global_cmvn_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "stats.npz", mean=rng.normal(size=80).astype(np.float32),
             std=np.abs(rng.normal(size=80)).astype(np.float32))
    cfg = {"stats_npz_path": str(tmp_path / "stats.npz")}
    x = _features(rng, 50)
    np.testing.assert_array_equal(ft.GlobalCMVN.from_config_dict(cfg)(x),
                                  jax_ft.GlobalCMVN.from_config_dict(cfg)(x))


def test_composite_equals_jax():
    cfg = {**CONFIG, "transforms": ["specaugment", "utterance_cmvn"]}
    x = _features(np.random.default_rng(5), 120)
    np.random.seed(9)
    got = ft.CompositeAudioFeatureTransform.from_config_dict(cfg)(x)
    np.random.seed(9)
    want = jax_ft.CompositeAudioFeatureTransform.from_config_dict(cfg)(x)
    np.testing.assert_array_equal(got, want)
    assert ft.CompositeAudioFeatureTransform.from_config_dict({"x": 1}) is None
    with pytest.raises(KeyError, match="unknown feature transform"):
        ft.CompositeAudioFeatureTransform.from_config_dict({"transforms": ["nope"]})


@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_examples_equal_jax(fbank_dir, split):
    """The split's transforms with their top-level parameters: each example
    (np.random seeded the same before it) equals the JAX dataset's, and the
    test split's is the utterance CMVN of the stored features."""
    root, feats = fbank_dir
    path = str(root / "config_wave.yaml")
    tgt = Dictionary.load(str(root / "dict.txt"))
    port = make_dataset_from_tsv(str(root), split, S2TDataConfig(path), tgt,
                                 split.startswith("train"))
    from chimera_st_tpu.data.dictionary import Dictionary as JaxDictionary

    ref = jax_dataset(str(root), split, JaxDataConfig(path),
                      JaxDictionary.load(str(root / "dict.txt")), split.startswith("train"))
    assert [type(t).__name__ for t in port.feature_transforms.transforms] == \
        [type(t).__name__ for t in ref.feature_transforms.transforms]
    if split == "train":
        spec = port.feature_transforms.transforms[0]
        assert (spec.freq_mask_n, spec.freq_mask_f, spec.time_warp_w) == (2, 9, 3)
    for i in range(len(feats)):
        np.random.seed(100 + i)
        got = port[i]
        np.random.seed(100 + i)
        want = ref[i]
        np.testing.assert_array_equal(got.audio, want.audio)
        np.testing.assert_array_equal(got.target, want.target)
        if split == "test":
            x = feats[i]
            np.testing.assert_array_equal(
                got.audio, (x - x.mean(axis=0)) / np.maximum(x.std(axis=0), 1e-8))


def test_fbank_serve_on_features_matches_jax_generator(fbank_dir, tmp_path):
    """A native ``s2t_transformer_s`` checkpoint (narrowed, 80-d feature
    input) served by the port's generate CLI on the test split (utterance
    CMVN): the JAX generator's tokens on the JAX task's batches, scores within
    1e-4 plus the printed rounding."""
    root, _ = fbank_dir
    model_cfg = dict(arch="s2t_transformer_s", conv_channels=16, encoder_embed_dim=16,
                     encoder_ffn_dim=32, encoder_layers=2, encoder_heads=2,
                     decoder_embed_dim=16, decoder_ffn_dim=32, decoder_layers=2,
                     decoder_heads=2)
    task = jax_setup_task({"_name": "speech_to_text", "data": str(root),
                           "config_yaml": "config_wave.yaml"})
    jax_model = task.build_model(dict(model_cfg))
    itr = task.make_batch_iterator(task.dataset("test"), max_sentences=4, seed=1,
                                   num_length_buckets=2)
    batches = list(itr.next_epoch_itr(shuffle=False))
    b0 = batches[0]
    params = jax_model.init(jax.random.PRNGKey(6), jnp.asarray(b0["audio"]),
                            jnp.asarray(b0["audio_padding_mask"]),
                            jnp.asarray(b0["prev_output_tokens"]))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 4.0
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path)
        else np.asarray(x), params)
    save_state(str(tmp_path / "s2t.ckpt"), SimpleNamespace(step=0, params=params, opt_state=None),
               {"model_cfg": dict(model_cfg)}, save_optimizer=False)
    d = task.target_dictionary
    gen = JaxGenerator(jax_model, JaxSettings(beam_size=3, max_decode_len=8, len_penalty=1.5),
                       pad=d.pad(), eos=d.eos(), unk=d.unk())
    want = {}
    for batch in batches:
        assert batch["audio"].ndim == 3 and batch["audio"].shape[-1] == 80
        tokens, scores, lens = map(np.asarray, gen.generate_audio(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(batch["audio"]),
            jnp.asarray(batch["audio_padding_mask"]),
            src_lengths=jnp.asarray(batch["audio_lengths"])))
        for b, sid in enumerate(batch["id"]):
            want[int(sid)] = (float(scores[b, 0]), d.string(tokens[b, 0, :int(lens[b, 0])]))
    out_dir = tmp_path / "port"
    out_dir.mkdir()
    generate.main([str(root), "--task", "speech_to_text", "--gen-subset", "test", "--beam", "3",
                   "--max-decode-len", "8", "--lenpen", "1.5", "--dtype", "float32",
                   "--batch-size", "4", "--num-length-buckets", "2", "--scoring", "bleu",
                   "--path", str(tmp_path / "s2t.ckpt"), "--results-path", str(out_dir),
                   "--device", "cpu"])
    lines = (out_dir / "generate-test.txt").read_text().splitlines()
    hyps = {int(line.split("\t")[0][2:]): line.split("\t")[1:]
            for line in lines if line.startswith("H-")}
    assert sorted(hyps) == sorted(want) and len(hyps) == 8
    assert len({h for _, h in hyps.values()}) > 2  # the hypotheses depend on the input
    for sid, (score, hyp) in want.items():
        assert hyps[sid][1] == hyp
        assert abs(float(hyps[sid][0]) - score) <= 1e-4 + 5e-5
