"""The PyTorch port's host data layer against the JAX package's, on the same
numpy-seeded inputs: dictionary, wav reading and writing, batching and bucket
edges, the native sentencepiece unigram encoder on a hand-built model, the
collated batches of the triplet and speech-to-text tasks on
``tests/synthetic_data.make_triplet_dir``, and the BLEU scorers. Everything
here is integer or exact host arithmetic, so results must be equal; audio
arrays are compared exactly too (both read the same 16-bit PCM)."""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chimera_st_tpu.data import audio as jax_audio
from chimera_st_tpu.data import batching as jax_batching
from chimera_st_tpu.data import dictionary as jax_dictionary
from chimera_st_tpu.data import encoders as jax_encoders
from chimera_st_tpu.data.spm import SentencePieceUnigram as JaxUnigram
from chimera_st_tpu.scoring import build_scorer as jax_build_scorer
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch.config.registry import get_registry
from chimera_st_tpu_torch.data import audio, batching, dictionary, encoders
from chimera_st_tpu_torch.data.manifests import S2TDataConfig, load_tsv
from chimera_st_tpu_torch.data.spm import SentencePieceUnigram
from chimera_st_tpu_torch.scoring import build_scorer
from chimera_st_tpu_torch.tasks import setup_task
from tests.synthetic_data import make_triplet_dir

ROOT = Path(__file__).resolve().parent.parent
PIECES = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -2.0, 1),
          ("▁the", -1.0, 1), ("▁d", -3.5, 1), ("og", -3.0, 1), ("▁dog", -2.2, 1),
          ("▁ca", -3.0, 1), ("t", -2.5, 1), ("▁cat", -2.4, 1), ("s", -2.0, 1),
          ("▁house", -2.8, 1), ("h", -4.0, 1), ("o", -4.0, 1), ("u", -4.0, 1), ("e", -4.0, 1),
          ("▁t", -3.0, 1), ("ree", -3.0, 1), ("r", -4.5, 1), ("▁a", -1.5, 1), ("a", -4.0, 1),
          ("c", -4.2, 1), ("d", -4.2, 1), ("g", -4.2, 1), ("ru", -3.2, 1), ("n", -3.9, 1),
          ("▁car", -2.6, 1)]
SENTENCES = ["the dog runs", "a cat", "  the   house  tree ", "the dogs catch a car", "xyz the q",
             "", "tree"]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    head = _varint((number << 3) | wire)
    return head + (_varint(len(payload)) + payload if wire == 2 else payload)


def write_spm_model(path, pieces, add_dummy_prefix=True) -> None:
    """A sentencepiece ``ModelProto`` with the pieces and a normalizer spec."""
    blob = b""
    for piece, score, typ in pieces:
        blob += _field(1, 2, _field(1, 2, piece.encode("utf-8"))
                       + _field(2, 5, struct.pack("<f", score)) + _field(3, 0, _varint(typ)))
    blob += _field(3, 2, _field(3, 0, _varint(int(add_dummy_prefix))) + _field(4, 0, _varint(1)))
    Path(path).write_bytes(blob)


# ------------------------------------------------------------- dictionary


@pytest.fixture(scope="module")
def dict_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("dict") / "dict.txt"
    words = [f"▁w{i}" if i % 3 else f"w{i}@@" for i in range(60)] + ["<lang:de>", "madeupword"]
    path.write_text("".join(f"{w} {int(rng.integers(1, 99))}\n" for w in words))
    return path


def test_dictionary_matches_jax(dict_file):
    d, ref = dictionary.Dictionary.load(str(dict_file)), jax_dictionary.Dictionary.load(
        str(dict_file))
    assert len(d) == len(ref) == 66
    assert (d.bos(), d.pad(), d.eos(), d.unk()) == (ref.bos(), ref.pad(), ref.eos(), ref.unk())
    assert d.symbols == ref.symbols and d.indices == ref.indices and d.count == ref.count
    assert d.unk_string() == ref.unk_string() and d.unk_string(True) == ref.unk_string(True)
    rng = np.random.default_rng(1)
    for _ in range(10):
        line = " ".join(rng.choice(d.symbols[4:] + ["never_seen"], size=int(rng.integers(0, 9))))
        for append_eos in (True, False):
            np.testing.assert_array_equal(d.encode_line(line, append_eos=append_eos),
                                          ref.encode_line(line, append_eos=append_eos))
        ids = d.encode_line(line)
        assert ids.dtype == ref.encode_line(line).dtype
        padded = np.concatenate([ids, [d.pad(), d.pad()]])
        for bpe in (None, "sentencepiece", "subword_nmt", "@@ "):
            assert d.string(padded, bpe_symbol=bpe) == ref.string(padded, bpe_symbol=bpe)
        strip = {d.index("<lang:de>")}
        assert d.string(padded, extra_symbols_to_ignore=strip) == \
            ref.string(padded, extra_symbols_to_ignore=strip)


@pytest.mark.parametrize("symbol", [None, "sentencepiece", "wordpiece", "letter", "silence",
                                    "_EOW", "subword_nmt", "@@ ", "@@", "none"])
def test_post_process_matches_jax(symbol):
    for s in ("▁the ▁do g s ▁run", "the@@ do@@ g runs", "_ t h e | d o g |", "a_EOW b c_EOW",
              "hel ##lo wor ##ld", "<SIL> a <SIL> b", ""):
        assert dictionary.post_process(s, symbol) == jax_dictionary.post_process(s, symbol)


# ------------------------------------------------------------------ audio


def test_wav_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    wav = (rng.normal(size=4321) * 0.3).clip(-1, 1).astype(np.float32)
    ours, theirs = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    audio.write_wav(ours, wav)
    jax_audio.write_wav(theirs, wav)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    got, sr = audio.read_wav(ours)
    ref, ref_sr = jax_audio.read_wav(ours)
    assert sr == ref_sr == 16000 and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    # 16-bit PCM, written as trunc(x * 32767) and read as n / 32768
    np.testing.assert_allclose(got, wav, atol=2.0 / 32768)
    got, _ = audio.read_wav(ours, frame_offset=100, frames=777)
    ref, _ = jax_audio.read_wav(ours, frame_offset=100, frames=777)
    np.testing.assert_array_equal(got, ref)
    assert len(got) == 777


def test_path_slices_and_feature_dispatch_match_jax(tmp_path):
    for p in ("a/b.wav:160:3200", "b.wav", "c:d.wav:5:6", "x.zip:10:-1", "odd:name"):
        assert audio.parse_path_with_slice(p) == jax_audio.parse_path_with_slice(p)
    rng = np.random.default_rng(3)
    audio.write_wav(str(tmp_path / "u.wav"), (rng.normal(size=2000) * 0.1).astype(np.float32))
    np.save(tmp_path / "f.npy", rng.normal(size=(7, 80)).astype(np.float32))
    for col in ("u.wav:40:1000", "u.wav", "f.npy"):
        np.testing.assert_array_equal(
            audio.get_features_or_waveform(col, True, str(tmp_path)),
            jax_audio.get_features_or_waveform(col, use_audio_input=True,
                                               audio_root=str(tmp_path)))
    with pytest.raises(ValueError):
        audio.get_features_or_waveform("u.wav", use_audio_input=False, audio_root=str(tmp_path))


# --------------------------------------------------------------- batching


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_by_size_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 400, size=57)
    order = np.argsort(-sizes, kind="stable")
    for kw in (dict(max_tokens=1000), dict(max_sentences=8), dict(max_tokens=1500, max_sentences=5),
               dict(max_tokens=2000, required_batch_size_multiple=4), dict()):
        got = batching.batch_by_size(order, sizes, **kw)
        ref = jax_batching.batch_by_size(order, sizes, **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n,n_buckets", [(5, 10), (40, 3), (200, 10), (3000, 8)])
def test_bucket_edges_and_padding_match_jax(n, n_buckets):
    rng = np.random.default_rng(n)
    lengths = (rng.gamma(2.0, 30000.0, size=n) + 1000).astype(np.int64)
    edges = batching.optimal_buckets(lengths, n_buckets)
    np.testing.assert_array_equal(edges, jax_batching.optimal_buckets(lengths, n_buckets))
    assert edges[-1] == lengths.max() and len(edges) <= max(n_buckets, 1)
    for length in list(lengths[:20]) + [1, int(lengths.max()) + 5]:
        assert batching.pad_to_bucket(length, edges) == jax_batching.pad_to_bucket(length, edges)
    for v in (0, 1, 15, 16, 17, 4095):
        assert batching.round16(v) == jax_batching.round16(v)
        assert batching.round16_or_none(v) == jax_batching.round16_or_none(v)


def test_collate_tokens_matches_jax():
    rng = np.random.default_rng(4)
    seqs = [rng.integers(4, 50, size=int(n)).astype(np.int32) for n in (5, 1, 9, 3)]
    for kw in (dict(), dict(target_len=16), dict(left_pad=True),
               dict(target_len=12, dtype=np.int64)):
        got = batching.collate_tokens(seqs, 1, **kw)
        ref = jax_batching.collate_tokens(seqs, 1, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


# -------------------------------------------------------------------- spm


@pytest.mark.parametrize("add_dummy_prefix", [True, False])
def test_spm_unigram_matches_jax(tmp_path, add_dummy_prefix):
    path = str(tmp_path / "hand.model")
    write_spm_model(path, PIECES, add_dummy_prefix)
    m, ref = SentencePieceUnigram.load(path), JaxUnigram.load(path)
    assert len(m) == len(ref) == len(PIECES)
    assert m.add_dummy_prefix == ref.add_dummy_prefix == add_dummy_prefix
    assert [m.id_to_piece(i) for i in range(len(m))] == [p for p, _, _ in PIECES]
    for s in SENTENCES:
        assert m.normalize(s) == ref.normalize(s)
        assert m.encode_pieces(s) == ref.encode_pieces(s)
        assert m.encode_ids(s) == ref.encode_ids(s)
        assert m.decode_pieces(m.encode_pieces(s)) == ref.decode_pieces(ref.encode_pieces(s))
    # the Viterbi path, not the greedy one: "▁dog" beats "▁d" + "og"
    assert SentencePieceUnigram(PIECES).encode_pieces("dog") == ["▁dog"]
    assert "<unk>" in m.encode_pieces("xyz")


def test_encoders_match_jax(tmp_path):
    path = str(tmp_path / "hand.model")
    write_spm_model(path, PIECES)
    cfg = {"_name": "sentencepiece", "sentencepiece_model": path}
    bpe, ref = encoders.build_bpe(cfg), jax_encoders.build_bpe(cfg)
    for s in SENTENCES:
        assert bpe.encode(s) == ref.encode(s)
        assert bpe.decode(bpe.encode(s)) == ref.decode(ref.encode(s))
    tok, ref_tok = (b({"_name": "space"}) for b in (encoders.build_tokenizer,
                                                     jax_encoders.build_tokenizer))
    for s in SENTENCES:
        assert tok.encode(s) == ref_tok.encode(s) and tok.decode(s) == ref_tok.decode(s)
    for name in ("bytes", "characters"):
        enc, ref_enc = encoders.build_bpe({"_name": name}), jax_encoders.build_bpe({"_name": name})
        for s in SENTENCES + ["Grüße, 世界"]:
            assert enc.encode(s) == ref_enc.encode(s)
            assert enc.decode(enc.encode(s)) == ref_enc.decode(ref_enc.encode(s))
    assert encoders.build_bpe(None) is None and encoders.build_tokenizer(None) is None
    with pytest.raises(KeyError, match="unknown bpe"):
        encoders.build_bpe({"_name": "no_such_bpe"})  # every JAX name is ported


# ------------------------------------------------------- tasks and batches


@pytest.fixture(scope="module")
def triplet_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("triplet")
    make_triplet_dir(str(root), n=11, seed=5)
    # a second data config with a sentencepiece model on both text sides
    write_spm_model(str(root / "hand.model"), PIECES)
    (root / "config_spm.yaml").write_text(
        f"audio_root: {root}\nuse_audio_input: true\nvocab_filename: spm_dict.txt\n"
        f"src_vocab_filename: spm_dict.txt\n"
        f"bpe_tokenizer:\n  bpe: sentencepiece\n  sentencepiece_model: {root}/hand.model\n"
        f"src_bpe_tokenizer:\n  bpe: sentencepiece\n  sentencepiece_model: {root}/hand.model\n")
    (root / "spm_dict.txt").write_text("".join(f"{p} 1\n" for p, _, typ in PIECES if typ == 1))
    return root


def assert_batches_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("task_name,config_yaml,kw", [
    ("triplet", "config_wave.yaml", dict(max_sentences=4, num_length_buckets=3)),
    ("triplet", "config_spm.yaml", dict(max_sentences=3, num_length_buckets=10)),
    ("triplet", "config_wave.yaml", dict(max_tokens=2000, num_length_buckets=2)),
    ("speech_to_text_triplet_infer", "config_wave.yaml", dict(max_sentences=8)),
    ("speech_to_text", "config_wave.yaml", dict(max_sentences=4, num_length_buckets=3)),
])
def test_collated_batches_match_jax(triplet_dir, task_name, config_yaml, kw):
    cfg = {"_name": task_name, "data": str(triplet_dir), "config_yaml": config_yaml}
    task, ref_task = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    assert len(task.target_dictionary) == len(ref_task.target_dictionary)
    ds, ref_ds = task.dataset("test"), ref_task.dataset("test")
    assert len(ds) == len(ref_ds) == 11
    assert [ds.num_tokens(i) for i in range(11)] == [ref_ds.num_tokens(i) for i in range(11)]
    itr = task.make_batch_iterator(ds, **kw)
    ref_itr = ref_task.make_batch_iterator(ref_ds, seed=1, **kw)
    assert len(itr) == len(ref_itr)
    got = list(itr.next_epoch_itr(shuffle=False))
    ref = list(ref_itr.next_epoch_itr(shuffle=False))
    assert len(got) == len(ref) >= 2
    for g, r in zip(got, ref):
        assert_batches_equal(g, r)
    # the seeded shuffle of a training epoch: the JAX package's order
    itr.next_epoch()
    ref_itr.next_epoch()
    shuffled = list(itr.next_epoch_itr(shuffle=True))
    ref_shuffled = list(ref_itr.next_epoch_itr(shuffle=True))
    assert [list(g["id"]) for g in shuffled] == [list(r["id"]) for r in ref_shuffled]
    for g, r in zip(shuffled, ref_shuffled):
        assert_batches_equal(g, r)
    # padded lengths come from the bucket edges, not from the batch's longest
    assert {g["audio"].shape[1] for g in got} <= set(
        batching.optimal_buckets([ds.num_tokens(i) for i in range(11)],
                                 kw.get("num_length_buckets", 10)).tolist())


def test_interactive_batches_match_jax(triplet_dir):
    cfg = {"_name": "triplet", "data": str(triplet_dir), "config_yaml": "config_wave.yaml"}
    task, ref_task = setup_task(dict(cfg)), jax_setup_task(dict(cfg))
    lines = [f"{triplet_dir}/wavs/u{i}.wav\n" for i in (3, 0, 7)]
    wavs, ref_wavs = task.get_interactive_examples(lines), ref_task.get_interactive_examples(lines)
    assert_batches_equal(task.batch_interactive(wavs), ref_task.batch_interactive(ref_wavs))
    assert task.batch_interactive(wavs)["audio"].shape[1] % 1280 == 0


def test_data_config_reads_json_without_yaml(triplet_dir):
    """``config_wave.yaml`` written as JSON reads the same with the ``yaml``
    package and, in a process where it cannot be imported, with ``json``."""
    cfg = {"audio_root": str(triplet_dir), "use_audio_input": True, "vocab_filename": "dict.txt",
           "bpe_tokenizer": {"bpe": None}}
    path = triplet_dir / "config_json.yaml"
    path.write_text(json.dumps(cfg))
    assert S2TDataConfig(str(path)).config == cfg
    probe = ("import sys, json; sys.modules['yaml'] = None\n"
             "from chimera_st_tpu_torch.data.manifests import S2TDataConfig\n"
             "print(json.dumps(S2TDataConfig(sys.argv[1]).config))\n"
             "try:\n    S2TDataConfig(sys.argv[2])\n"
             "except RuntimeError as e:\n    print('raised')\n")
    proc = subprocess.run([sys.executable, "-c", probe, str(path),
                           str(triplet_dir / "config_wave.yaml")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert json.loads(out[0]) == cfg and out[1] == "raised"


def test_feature_transforms_and_joined_splits_raise(triplet_dir):
    (triplet_dir / "config_tf.yaml").write_text(
        f"audio_root: {triplet_dir}\nvocab_filename: dict.txt\n"
        "transforms:\n  '*': [utterance_cmvn]\n")
    task = setup_task({"_name": "speech_to_text", "data": str(triplet_dir),
                       "config_yaml": "config_tf.yaml"})
    task.load_dataset("test")  # ported: the transforms of features are built
    assert [type(t).__name__ for t in task.dataset("test").feature_transforms.transforms] == \
        ["UtteranceCMVN"]
    # a transform that neither package knows raises
    (triplet_dir / "config_tf.yaml").write_text(
        f"audio_root: {triplet_dir}\nvocab_filename: dict.txt\n"
        "transforms:\n  '*': [warp_drive]\n")
    task = setup_task({"_name": "speech_to_text", "data": str(triplet_dir),
                       "config_yaml": "config_tf.yaml"})
    with pytest.raises(KeyError, match="unknown feature transform"):
        task.load_dataset("test")
    # comma-joined splits are concatenated (tests/test_torch_mt.py holds
    # their resampling against the JAX package)
    task = setup_task({"_name": "triplet", "data": str(triplet_dir),
                       "config_yaml": "config_wave.yaml"})
    task.load_dataset("train,valid")
    assert len(task.dataset("train,valid")) == len(task.dataset("train")) + len(
        task.dataset("valid"))
    assert len(load_tsv(str(triplet_dir / "test.tsv"))) == 11


# ---------------------------------------------------------------- registry


def test_registry_lists_what_is_ported():
    import chimera_st_tpu_torch.models  # noqa: F401 — registration
    import chimera_st_tpu_torch.scoring  # noqa: F401
    import chimera_st_tpu_torch.tasks  # noqa: F401

    assert {"triplet", "speech_to_text_triplet_infer", "speech_to_text", "translation"} <= set(
        get_registry("task").keys())
    archs = set(get_registry("architecture").keys())
    assert {"s2t_transformer_w2v2_interlingua_base", "s2t_transformer", "s2t_transformer_s",
            "s2t_transformer_sp", "s2t_transformer_m", "s2t_transformer_mp", "s2t_transformer_l",
            "s2t_transformer_lp"} <= archs
    assert {"bleu", "sacrebleu"} <= set(get_registry("scoring").keys())
    # the Transformer family and its LM task
    assert "language_modeling" in set(get_registry("task").keys())
    assert {"transformer", "transformer_wmt_en_de_big", "transformer_iwslt_de_en",
            "transformer_lm", "transformer_lm_gpt"} <= archs
    # BART / mBART, multilingual translation, the masked-LM family and the
    # zoo's benchmark and classification tasks are ported
    assert {"multilingual_translation", "denoising", "sentence_prediction", "masked_lm",
            "semisupervised_translation", "dummy_mt", "dummy_lm", "dummy_masked_lm",
            "simple_classification"} <= set(get_registry("task").keys())


# ------------------------------------------------------------------- bleu


def test_bleu_scorers_match_jax(dict_file):
    d = dictionary.Dictionary.load(str(dict_file))
    rng = np.random.default_rng(6)
    ours, ref = build_scorer({"_name": "bleu"}, d), jax_build_scorer({"_name": "bleu"}, d)
    ours_sb = build_scorer({"_name": "sacrebleu"}, d)
    ref_sb = jax_build_scorer({"_name": "sacrebleu"}, d)
    for _ in range(12):
        target = rng.integers(4, 30, size=int(rng.integers(3, 14))).tolist() + [d.eos()]
        hyp = [t if rng.random() < 0.7 else int(rng.integers(4, 30)) for t in target[:-1]]
        hyp = hyp[: int(rng.integers(2, len(hyp) + 1))] + [d.eos()]
        ours.add(target, hyp)
        ref.add(target, hyp)
        ours_sb.add_string(d.string(target), d.string(hyp))
        ref_sb.add_string(d.string(target), d.string(hyp))
    assert ours.result_string() == ref.result_string()
    assert ours.score() == pytest.approx(ref.score(), abs=1e-9) and ours.score() > 0
    for order in (1, 2, 3):
        assert ours.score(order) == pytest.approx(ref.score(order), abs=1e-9)
    assert ours_sb.result_string() == ref_sb.result_string()
    assert ours_sb.score() == pytest.approx(ref_sb.score(), abs=1e-9)
    ours_chrf = build_scorer({"_name": "chrf"}, d)
    ref_chrf = jax_build_scorer({"_name": "chrf"}, d)
    for _ in range(6):
        target = rng.integers(4, 30, size=int(rng.integers(3, 14))).tolist()
        hyp = [t if rng.random() < 0.7 else int(rng.integers(4, 30)) for t in target]
        ours_chrf.add_string(d.string(target), d.string(hyp))
        ref_chrf.add_string(d.string(target), d.string(hyp))
    assert ours_chrf.result_string() == ref_chrf.result_string()
    assert ours_chrf.score() == ref_chrf.score() > 0
