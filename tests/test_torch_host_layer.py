"""The port's host layer against the JAX package on the CPU: the C++ batch
packer and edit distance, the decoded-waveform cache, the training wire
format (int16 PCM, no padding mask), the dataset wrappers, quantile buckets,
layer pruning, length dropout and the HDFS pipes.

Tolerances: none. Every comparison is exact (the same integers, the same
arrays bit for bit, the same fp32 loss of one CPU update).
"""

import dataclasses
import importlib
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import prune_layer_params as jax_prune_layer_params
from chimera_st_tpu.clib import batch_by_size_native as jax_batch_by_size_native
from chimera_st_tpu.clib import libnat as jax_libnat
from chimera_st_tpu.data import audio as jax_audio
from chimera_st_tpu.data import batching as jax_batching
from chimera_st_tpu.data import manifests as jax_manifests
from chimera_st_tpu.data import wrappers as jax_wrappers
from chimera_st_tpu.data.dictionary import Dictionary as JaxDictionary
from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
from chimera_st_tpu.train.train_step import prepare_batch as jax_prepare_batch
from chimera_st_tpu.utils import hdfs as jax_hdfs
from chimera_st_tpu_torch.checkpoint.store import prune_layer_params
from chimera_st_tpu_torch.convert import params_to_flax
from chimera_st_tpu_torch.data import audio, batching, manifests, wrappers
from chimera_st_tpu_torch.data.dictionary import Dictionary
from chimera_st_tpu_torch.models.chi_utils import length_dropout
from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, init_params_
from chimera_st_tpu_torch.scoring.wer import levenshtein, levenshtein_plain
from chimera_st_tpu_torch.train import prepare_batch
from chimera_st_tpu_torch.utils import hdfs
from tests.synthetic_data import TINY_ARCH_FLAGS, make_triplet_dir
from tests.test_interlingua_model import TINY
from tests.test_torch_models import port_config

# ------------------------------------------------------------ batch packing

PACKING = {  # max_tokens, max_sentences, required_batch_size_multiple
    "tokens": (4000, None, 1),
    "sentences": (None, 10, 1),
    "both_mult8": (3000, 20, 8),
    "one_over_max_tokens": (500, None, 1),
}


@pytest.mark.parametrize("case", PACKING)
def test_batch_by_size_matches_jax_and_the_python_loop(case):
    """Seeded sizes walked in length order, as the tasks walk them: the C++
    packer's batches equal the JAX package's native ones and the Python
    loop's; with a size over ``max_tokens`` both packages take the Python
    loop, which raises."""
    max_tokens, max_sentences, mult = PACKING[case]
    rng = np.random.default_rng(11)
    sizes = rng.integers(1, 400, size=3000).astype(np.int64)
    if case == "one_over_max_tokens":
        sizes[17] = 501
    order = np.argsort(sizes, kind="stable")
    if case == "one_over_max_tokens":
        with pytest.raises(ValueError, match="exceeds max_tokens"):
            batching.batch_by_size(order, sizes, max_tokens, max_sentences, mult)
        with pytest.raises(AssertionError):
            jax_batching.batch_by_size(order, sizes, max_tokens, max_sentences, mult)
        return
    got = batching.batch_by_size(order, sizes, max_tokens, max_sentences, mult)
    plain = batching.batch_by_size_plain(order, sizes, max_tokens, max_sentences, mult)
    ends = jax_batch_by_size_native(sizes[order], max_tokens, max_sentences, mult)
    want = list(np.split(order, ends[:-1]))
    assert len(got) == len(plain) == len(want) > 10
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(p, w)
    assert any(len(b) % mult == 0 for b in got[:-1])


def test_levenshtein_matches_jax_libnat():
    """Word sequences (the WER's), int sequences and empty ones: the C++
    distance equals the Python programme's and the JAX package's
    ``libnat.levenshtein``."""
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(12)]
    pairs = [(list(rng.choice(words, size=rng.integers(0, 14))),
              list(rng.choice(words, size=rng.integers(0, 14)))) for _ in range(200)]
    pairs += [([], []), ([], ["a"]), (["a", "b"], []), ([3, 1, 2], [1, 2, 3, 4])]
    for a, b in pairs:
        d = levenshtein(a, b)
        assert d == levenshtein_plain(a, b) == jax_libnat.levenshtein(a, b), (a, b)


# ------------------------------------------------------- the waveform cache


def test_wav_cache_evicts_counts_and_serves_repeat_reads(tmp_path):
    """The byte-capped LRU as the JAX package's (``tests/test_host_pipeline.py``):
    least recently used out, an array over the cap never kept, hits and
    misses counted; a repeat read is the cached array, read-only; 0 MiB
    turns the cache off."""
    for cls in (audio._LRUByteCache, jax_audio._LRUByteCache):
        c = cls(max_bytes=3 * 8 * 10)  # room for 3 float64[10]
        for k in "abc":
            c.put(k, np.zeros(10))
        assert c.get("a") is not None
        c.put("d", np.zeros(10))  # evicts b
        assert c.get("b") is None
        assert c.get("a") is not None and c.get("d") is not None
        c.put("huge", np.zeros(1000))
        assert c.get("huge") is None
        assert (c.hits, c.misses, c._bytes) == (3, 2, 240)

    wav = (np.sin(np.arange(400) / 10) * 0.3).astype(np.float32)
    p = str(tmp_path / "c.wav")
    audio.write_wav(p, wav)
    audio.configure_wav_cache(64)
    try:
        a = audio.get_features_or_waveform(p)
        b = audio.get_features_or_waveform(p)
        assert a is b and not a.flags.writeable
        np.testing.assert_array_equal(a, jax_audio.get_features_or_waveform(p))
        assert audio.wav_cache_stats() == {"hits": 1, "misses": 1, "bytes": a.nbytes}
        i16 = audio.get_features_or_waveform(p, int16=True)  # its own key
        assert i16.dtype == np.int16 and audio.wav_cache_stats()["misses"] == 2
        audio.configure_wav_cache(0)
        assert audio.wav_cache_stats() is None
        assert audio.get_features_or_waveform(p) is not audio.get_features_or_waveform(p)
    finally:
        audio.configure_wav_cache(512)


def test_wav_cache_keeps_its_counts_under_threads():
    """32 threads (more than the cores) read and write one small cache with
    a short switch interval: every get is counted once, and the bytes held
    are the sum of the arrays held, within the cap."""
    import threading

    cache = audio._LRUByteCache(max_bytes=50 * 800)
    gets_each, n_threads = 400, 32

    def work(t):
        rng = np.random.default_rng(t)
        for _ in range(gets_each):
            key = int(rng.integers(0, 120))
            if cache.get(key) is None:
                cache.put(key, np.zeros(100))  # 800 bytes

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert cache.hits + cache.misses == gets_each * n_threads and cache.hits > 0
    assert cache._bytes == sum(a.nbytes for a in cache._store.values()) <= cache.max_bytes


def test_wav_cache_size_from_the_environment(monkeypatch):
    """``CHIMERA_WAV_CACHE_MB`` sizes the cache at import (512 MiB unset, 0
    none), as in the JAX package."""
    try:
        for value, want in (("3", 3 << 20), ("0", None), (None, 512 << 20)):
            if value is None:
                monkeypatch.delenv("CHIMERA_WAV_CACHE_MB", raising=False)
            else:
                monkeypatch.setenv("CHIMERA_WAV_CACHE_MB", value)
            importlib.reload(audio)
            cache = audio._wav_cache
            assert (cache.max_bytes if cache is not None else None) == want
    finally:
        monkeypatch.delenv("CHIMERA_WAV_CACHE_MB", raising=False)
        importlib.reload(audio)


def test_int16_read_is_lossless_and_equal_to_jax(tmp_path):
    wav = (np.sin(np.arange(1000) / 7) * 0.8).astype(np.float32)
    p = str(tmp_path / "i.wav")
    audio.write_wav(p, wav)
    f32, _ = audio.read_wav(p)
    i16, _ = audio.read_wav(p, int16=True)
    assert i16.dtype == np.int16
    np.testing.assert_array_equal(i16.astype(np.float32) / 32768.0, f32)
    np.testing.assert_array_equal(i16, jax_audio.read_wav(p, int16=True)[0])
    sliced, _ = audio.read_wav(p, frame_offset=100, frames=50, int16=True)
    np.testing.assert_array_equal(sliced, i16[100:150])


# ------------------------------------------------------- the wire format


@pytest.fixture(scope="module")
def triplet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("triplet")
    make_triplet_dir(str(root), n=8, seed=3)
    with open(root / "config_wave.yaml", "a") as f:
        f.write("sampling_alpha: 0.5\n")
    return root


def _datasets(pkg_manifests, dictionary_cls, root, split, triplet=True):
    d = dictionary_cls.load(str(root / "dict.txt"))
    cfg = pkg_manifests.TripletDataConfig(str(root / "config_wave.yaml"))
    return pkg_manifests.make_dataset_from_tsv(str(root), split, cfg, d, is_train=True,
                                               src_dict=d, triplet=triplet, seed=2)


def _leaves(ds, seen=None):
    """Every dataset under ``ds`` through ``datasets`` / ``dataset``."""
    seen = seen if seen is not None else []
    seen.append(ds)
    subs = getattr(ds, "datasets", None)
    for sub in (subs.values() if isinstance(subs, dict) else subs or ()):
        _leaves(sub, seen)
    inner = getattr(ds, "dataset", None)
    if inner is not None and not callable(inner):
        _leaves(inner, seen)
    return seen


def test_set_wire_format_walks_the_jax_wrappers(triplet_root):
    """Comma-joined training splits (concatenated, temperature-resampled),
    held in a joint-style dict and a token wrapper: the same datasets get
    the wire format in both packages, and only the manifest datasets."""
    trees = []
    for pkg_manifests, pkg_wrappers, dictionary_cls in (
            (manifests, wrappers, Dictionary), (jax_manifests, jax_wrappers, JaxDictionary)):
        joined = _datasets(pkg_manifests, dictionary_cls, triplet_root, "train,valid")
        single = _datasets(pkg_manifests, dictionary_cls, triplet_root, "test", triplet=False)

        class Joint:
            datasets = {"st": joined, "mt": pkg_wrappers.TruncateDataset(single, 10)}

        pkg_manifests.set_wire_format(Joint())
        leaves = {id(d): d for d in _leaves(Joint())}.values()
        trees.append([(type(d).__name__, vars(d).get("wire_int16"), vars(d).get("device_mask"))
                      for d in leaves])
    got, want = trees
    assert got == want
    flagged = sorted(t for t in got if t[1] is not None)
    assert flagged == [("SpeechToTextDataset", True, True)] + [("TripletDataset", True, True)] * 2
    assert "ResamplingDataset" in [t[0] for t in got]


@pytest.mark.parametrize("wire", [False, True])
def test_collated_batch_equals_jax_key_for_key(triplet_root, wire):
    """The same samples collated by both packages, with and without the
    wire format: the same keys (no padding mask on the wire), dtypes and
    values."""
    batches = []
    for pkg_manifests, dictionary_cls in ((manifests, Dictionary),
                                          (jax_manifests, JaxDictionary)):
        ds = _datasets(pkg_manifests, dictionary_cls, triplet_root, "train")
        if wire:
            pkg_manifests.set_wire_format(ds)
        batches.append(ds.collater([ds[i] for i in (5, 0, 3)], audio_target_len=912,
                                   text_target_len=8, src_target_len=8))
    got, want = batches
    assert sorted(got) == sorted(want)
    assert ("audio_padding_mask" in got) is not wire
    assert got["audio"].dtype == (np.int16 if wire else np.float32)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_prepare_batch_of_a_wire_batch_equals_the_float_batch(triplet_root):
    """``prepare_batch`` rebuilds the float audio and the padding mask of a
    wire batch exactly, as the JAX package's does; a float batch passes
    through."""
    ds = _datasets(manifests, Dictionary, triplet_root, "train")
    samples = [0, 1, 2, 3]
    ref = ds.collater([ds[i] for i in samples], audio_target_len=912)
    manifests.set_wire_format(ds)
    wire = ds.collater([ds[i] for i in samples], audio_target_len=912)
    out, out_ref = prepare_batch(wire, "cpu"), prepare_batch(ref, "cpu")
    assert out["audio"].dtype == torch.float32
    for k in ("audio", "audio_padding_mask", "audio_lengths", "target"):
        assert torch.equal(out[k], out_ref[k]), k
    np.testing.assert_array_equal(out_ref["audio"].numpy(), ref["audio"])
    jax_out = jax_prepare_batch({k: jnp.asarray(v) for k, v in wire.items()})
    for k in ("audio", "audio_padding_mask"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jax_out[k]), err_msg=k)


def test_cli_train_ships_the_wire_and_one_update_gives_the_same_loss(triplet_root, tmp_path,
                                                                     monkeypatch):
    """``cli.train`` on the tiny flagship, one fp32 CPU update with dropout
    on, by default and with ``--no-host-wire``: by default the
    micro-batches reach ``prepare_batch`` as int16 audio without a padding
    mask, with the flag as float32 with the mask; the logged loss and gnorm
    and the parameters after are the same both ways, bit for bit."""
    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.train import train_step
    from chimera_st_tpu_torch.train.trainer import Trainer

    seen, updates = [], []
    prepare, record = train_step.prepare_batch, Trainer._record_update

    def noting_prepare(batch, device):
        seen.append((batch["audio"].dtype, "audio_padding_mask" in batch))
        return prepare(batch, device)

    def noting_record(self, m, num_updates):
        updates.append((float(m["loss"]), float(m["gnorm"])))
        return record(self, m, num_updates)

    monkeypatch.setattr(train_step, "prepare_batch", noting_prepare)
    monkeypatch.setattr(Trainer, "_record_update", noting_record)
    argv = [str(triplet_root), "--task", "triplet", *TINY_ARCH_FLAGS,
            "--criterion", "triplet_st_mt_contrastive", "--label-smoothing", "0.1",
            "--optimizer", "adam", "--lr", "1e-3", "--lr-scheduler", "fixed",
            "--batch-size", "4", "--max-update", "1", "--dtype", "float32",
            "--num-length-buckets", "2", "--disable-validation", "--no-save", "--device", "cpu"]
    params = []
    for extra in ([], ["--no-host-wire"]):
        out = train.main(argv + ["--save-dir", str(tmp_path / str(len(params))), *extra])
        params.append(out["trainer"].model.state_dict())
    assert seen == [(np.int16, False), (np.float32, True)]
    assert len(updates) == 2 and updates[0] == updates[1] and np.isfinite(updates[0][0])
    for k, v in params[0].items():
        assert torch.equal(v, params[1][k]), k


# ------------------------------------------------------------- the wrappers


class _Toks:
    def __init__(self, items):
        self.items, self.calls = items, []

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        self.calls.append(int(i))
        return self.items[int(i)]

    def num_tokens(self, i):
        return len(self.items[int(i)])

    def collater(self, samples, **kw):
        return {"items": [np.asarray(s).tolist() if isinstance(s, np.ndarray) else s
                          for s in samples]}


class _Dicts(_Toks):
    def __getitem__(self, i):
        self.calls.append(int(i))
        return {"id": int(i), "tokens": self.items[int(i)]}

    def collater(self, samples, **kw):
        return {"id": np.asarray([s["id"] for s in samples])}


def _toks(n=10, seed=0, cls=_Toks):
    rng = np.random.default_rng(seed)
    return cls([rng.integers(4, 50, size=int(rng.integers(1, 12))).astype(np.int32)
                for _ in range(n)])


def _as_list(x):
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, dict):
        return {k: _as_list(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_list(v) for v in x]
    return x


def _views(make, epochs=(1, 2, 3), collates=((0, 1, 2), (3, 4), (5, 6, 7, 8))):
    """Everything a wrapper shows: its length, items and sizes, its
    collated batches and the base's reads, over several epochs."""
    ds, bases = make()
    out = []
    for epoch in epochs:
        if hasattr(ds, "set_epoch"):
            ds.set_epoch(epoch)
        n = len(ds)
        out.append((n, [_as_list(ds[i]) for i in range(n)],
                    [ds.num_tokens(i) for i in range(n)],
                    [_as_list(ds.collater([ds[i] for i in idx if i < n])) for idx in collates],
                    [list(b.calls) for b in bases]))
    return out


WRAPPERS = {
    "append": lambda w: (lambda b: (w.AppendTokenDataset(b, 2), [b]))(_toks()),
    "prepend": lambda w: (lambda b: (w.PrependTokenDataset(b, 0), [b]))(_toks()),
    "truncate": lambda w: (lambda b: (w.TruncateDataset(b, 4), [b]))(_toks()),
    "subsample": lambda w: (lambda b: (w.SubsampleDataset(b, 0.5, seed=7), [b]))(_toks(15)),
    "backtranslation": lambda w: (lambda b: (w.BacktranslationDataset(
        b, lambda ts: [t[::-1].copy() for t in ts], lambda pairs, **kw: pairs), [b]))(_toks()),
    "lru_cache": lambda w: (lambda b: (w.LRUCacheDataset(b, max_size=3), [b]))(_toks()),
    "colorize": lambda w: (lambda b: (w.ColorizeDataset(b, lambda d, i: 100 + 2 * i), [b]))(
        _toks(cls=_Dicts)),
    "multi_corpus_sampled": lambda w: (lambda a, b: (w.MultiCorpusSampledDataset(
        {"a": a, "b": b}, seed=4), [a, b]))(_toks(4, 1), _toks(9, 2)),
    "multi_corpus": lambda w: (lambda a, b: (w.MultiCorpusDataset(
        {"a": a, "b": b}, [0.7, 0.3], seed=4), [a, b]))(_toks(6, 1), _toks(9, 2)),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_matches_jax(name):
    """Each of the nine wrappers over the same seeded token items as the
    JAX package's: lengths, items, sizes, collated batches and the reads
    it makes of its bases, over epochs 1-3."""
    got = _views(lambda: WRAPPERS[name](wrappers))
    want = _views(lambda: WRAPPERS[name](jax_wrappers))
    assert got == want


def test_wrappers_refuse_what_jax_refuses():
    with pytest.raises(ValueError):
        wrappers.SubsampleDataset(_toks(), 1.5)
    with pytest.raises(ValueError):
        wrappers.MultiCorpusDataset({"a": _toks(), "b": _toks(cls=_Dicts)}, [0.5, 0.5])
    with pytest.raises(ValueError):
        wrappers.MultiCorpusDataset({"a": _toks(), "b": _Toks([])}, [0.5, 0.5])


# ------------------------------------------------- buckets and layer pruning


def test_quantile_buckets_match_jax():
    rng = np.random.default_rng(3)
    for lengths in (rng.integers(1, 300, size=500), np.exp(rng.normal(4, 1, 2000)).astype(int) + 1,
                    np.asarray([7] * 20)):
        for k in (1, 3, 10, 40):
            np.testing.assert_array_equal(batching.quantile_buckets(lengths, k),
                                          jax_batching.quantile_buckets(lengths, k))


def test_pruned_decoder_converts_to_the_jax_pruned_tree():
    """A 3-layer decoder's state dict pruned to layers 0 and 2 loads into a
    2-layer port model; converted to flax it equals the JAX package's
    pruning of the converted 3-layer tree leaf for leaf, and has the tree
    of the JAX model at 2 layers."""
    deep = ChimeraInterlinguaModel(port_config(dataclasses.replace(TINY, decoder_layers=3)),
                                   device="cpu")
    init_params_(deep, torch.Generator().manual_seed(0))
    pruned = prune_layer_params(deep.state_dict(), "0,2", prefix="decoder.layers.")
    shallow = ChimeraInterlinguaModel(port_config(TINY), device="cpu")
    shallow.load_state_dict(pruned, strict=True)
    got = params_to_flax(shallow.state_dict())["params"]
    full = params_to_flax(deep.state_dict())["params"]
    want = dict(full, decoder=jax_prune_layer_params(full["decoder"], "0,2"))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (p, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))
    shapes = jax.eval_shape(lambda: JaxModel(TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 400)), jnp.zeros((2, 400), bool),
        jnp.zeros((2, 4), jnp.int32), jnp.zeros((2, 5), jnp.int32),
        method=JaxModel.init_everything))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(got)
    assert all(s.shape == np.shape(g) for s, g in zip(jax.tree_util.tree_leaves(shapes),
                                                      jax.tree_util.tree_leaves(got)))
    with pytest.raises(KeyError):
        prune_layer_params(deep.state_dict(), [7], prefix="decoder.layers.")


# ------------------------------------------------ length dropout and HDFS


def test_length_dropout_keeps_its_invariants():
    x = torch.ones(3, 40, 4)
    mask = torch.zeros(3, 40, dtype=torch.bool)
    mask[2, 30:] = True
    x[2, 30:] = 5.0  # pads with values: zeroed as JAX zeroes every masked step
    y, m = length_dropout(x, mask, 0.5, torch.Generator().manual_seed(0), deterministic=False)
    added = m & ~mask
    assert added.any() and (m | ~mask).all() and not m[:, 0].any()
    assert (y[m] == 0).all() and (y[~m] == 1).all()
    assert 0.3 < added[:2].float().mean() < 0.7
    y2, m2 = length_dropout(x, mask, 0.5, torch.Generator().manual_seed(0), deterministic=False)
    assert torch.equal(m, m2) and torch.equal(y, y2)
    for args in ((0.5, None, False), (0.5, torch.Generator(), True), (0.0, torch.Generator(),
                                                                       False)):
        same_x, same_m = length_dropout(x, mask, *args)
        assert same_x is x and same_m is mask


FAKE_HDFS = """#!{python}
import os, shutil, sys
root = {root!r}
args = sys.argv[1:]
assert args[0] == "dfs", args
local = lambda p: os.path.join(root, p[len("hdfs://"):].replace("/", "_"))
if args[1] == "-cat":
    with open(local(args[2]), "rb") as f:
        sys.stdout.buffer.write(f.read())
elif args[1:4] == ["-put", "-f", "-"]:
    with open(local(args[4]), "wb") as f:
        shutil.copyfileobj(sys.stdin.buffer, f)
elif args[1:3] == ["-appendToFile", "-"]:
    with open(local(args[3]), "ab") as f:
        shutil.copyfileobj(sys.stdin.buffer, f)
else:
    sys.exit(2)
"""


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_hdfs_local_passthrough_and_pipes(tmp_path, monkeypatch, pkg):
    """A local path passes through to ``open``; an ``hdfs://`` path goes
    through ``hdfs dfs -cat`` / ``-put -f`` / ``-appendToFile`` (a fake
    ``hdfs`` on ``PATH`` over a directory), in both packages alike."""
    mod = hdfs if pkg == "port" else jax_hdfs
    assert mod.is_hdfs_path("hdfs://nn/a/b") and not mod.is_hdfs_path("/tmp/x")
    local = str(tmp_path / "o.pkl")
    mod.save_pickle({"a": 1}, local)
    assert mod.load_pickle(local) == {"a": 1}
    bin_dir, store = tmp_path / "bin", tmp_path / "store"
    bin_dir.mkdir()
    store.mkdir()
    (bin_dir / "hdfs").write_text(FAKE_HDFS.format(python=sys.executable, root=str(store)))
    (bin_dir / "hdfs").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    assert mod.hdfs_available()
    path = "hdfs://nn/ckpt/state.pkl"
    mod.save_pickle({"w": [1, 2, 3]}, path)
    assert mod.load_pickle(path) == {"w": [1, 2, 3]}
    with mod.hopen("hdfs://nn/log.txt", "wb") as f:
        f.write(b"one\n")
    with mod.hopen("hdfs://nn/log.txt", "ab") as f:
        f.write(b"two\n")
    with mod.hopen("hdfs://nn/log.txt", "rb") as f:
        assert f.read() == b"one\ntwo\n"
    assert sorted(p.name for p in Path(store).iterdir()) == ["nn_ckpt_state.pkl", "nn_log.txt"]
    with pytest.raises(ValueError):
        with mod.hopen(path, "x"):
            pass


def test_accuracy_counts_match_jax():
    from chimera_st_tpu.criterions.label_smoothed_ce import accuracy_counts as jax_accuracy_counts
    from chimera_st_tpu_torch.criterions.label_smoothed_ce import accuracy_counts

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    target = rng.integers(0, 11, size=(3, 7))
    target[:, 5:] = 1
    got = accuracy_counts(torch.from_numpy(logits), torch.from_numpy(target))
    want = jax_accuracy_counts(jnp.asarray(logits), jnp.asarray(target))
    keep = target != 1
    assert [int(g) for g in got] == [int(w) for w in want] == [
        int(((logits.argmax(-1) == target) & keep).sum()), int(keep.sum())]
