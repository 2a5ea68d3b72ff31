"""The rest of the JAX package's public surface in the port, against the JAX
package on the CPU: ``ChimeraConfig``'s YAML round trip (each package reads
the other's), the FASTA datasets and their shared index cache, the mask and
parameter-count helpers, ``tools/prep_mustc_data`` on a seeded fixture in
MuST-C's layout (wavs, a segment YAML, parallel text; identical manifests
for raw audio, features within 1e-4 for fbank80), ``tools/plot_training``
on a log the port's train CLI writes, and ``--user-dir``."""

import json
import logging
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chimera_st_tpu.config.configs import ChimeraConfig as JaxConfig
from chimera_st_tpu.data.fasta import EncodedFastaDataset as JaxEncodedFasta
from chimera_st_tpu.tools import plot_training as jax_plot
from chimera_st_tpu.tools import prep_mustc_data as jax_prep
from chimera_st_tpu.utils import masking as jax_masking
from chimera_st_tpu.utils import trees as jax_trees
from chimera_st_tpu_torch.cli import options, train
from chimera_st_tpu_torch.config.configs import ChimeraConfig
from chimera_st_tpu_torch.data.audio import write_wav
from chimera_st_tpu_torch.data.dictionary import Dictionary
from chimera_st_tpu_torch.data.fasta import EncodedFastaDataset, FastaDataset
from chimera_st_tpu_torch.tools import plot_training, prep_mustc_data
from chimera_st_tpu_torch.utils import (lengths_to_padding_mask, padding_mask_to_lengths,
                                        param_count, tree_size_bytes)


def test_config_yaml_round_trips_through_both_packages():
    cfg = ChimeraConfig()
    cfg = cfg.replace(common=cfg.common.replace(seed=7, dtype="float32"),
                      optimization=cfg.optimization.replace(lr=[5e-4], update_freq=[8]),
                      model={"_name": "lstm", "hidden_size": 16},
                      generation=cfg.generation.replace(beam=10, lenpen=1.5))
    text = cfg.to_yaml()
    assert text == JaxConfig.from_yaml(text).to_yaml()
    assert ChimeraConfig.from_yaml(JaxConfig.from_yaml(text).to_yaml()) == cfg
    assert JaxConfig().to_dict() == ChimeraConfig().to_dict()
    assert ChimeraConfig.from_dict({"common": {"seed": 3}, "unknown": 1}).common.seed == 3


def test_fasta_datasets_and_their_index_cache_match_jax(tmp_path):
    (tmp_path / "p.fasta").write_text(">a one\nACDE\nFG\n>b two\n\nKLM\n>c\nAC\n")
    d = Dictionary()
    for ch in "ACDEFGKLM":
        d.add_symbol(ch)
    ours = FastaDataset(str(tmp_path / "p"))
    assert [ours[i] for i in range(3)] == [(">a one", "ACDEFG"), (">b two", "KLM"), (">c", "AC")]
    assert list(ours.sizes) == [6, 3, 2]
    enc = EncodedFastaDataset(str(tmp_path / "p"), d)  # writes the index cache
    theirs = JaxEncodedFasta(str(tmp_path / "p"), d)  # reads it
    for i in range(3):
        np.testing.assert_array_equal(enc[i], theirs[i])
    np.testing.assert_array_equal(theirs.offsets, ours.offsets)


def test_masks_and_parameter_counts_match_jax():
    lengths = np.array([3, 0, 5])
    mask = lengths_to_padding_mask(torch.from_numpy(lengths), 6)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_masking.lengths_to_padding_mask(jnp.asarray(lengths), 6)))
    np.testing.assert_array_equal(padding_mask_to_lengths(mask).numpy(), lengths)
    tree = {"a": np.zeros((3, 4), np.float32), "b": {"c": np.zeros(5, np.int16)}}
    assert param_count(tree) == jax_trees.param_count(tree) == 17
    assert tree_size_bytes(tree) == jax_trees.tree_size_bytes(tree) == 58
    module = torch.nn.Linear(4, 3)
    assert param_count(module) == 15 and tree_size_bytes(module.state_dict()) == 60


@pytest.fixture(scope="module")
def mustc(tmp_path_factory):
    """en-de in MuST-C's layout: two talks, five segments in dev."""
    root = tmp_path_factory.mktemp("mustc")
    rng = np.random.default_rng(4)
    split = root / "en-de" / "data" / "dev"
    (split / "wav").mkdir(parents=True)
    (split / "txt").mkdir()
    segs = []
    for talk in ("ted_1", "ted_2"):
        write_wav(str(split / "wav" / f"{talk}.wav"),
                  (rng.normal(size=16000 * 3) * 0.1).astype(np.float32))
    for i, (talk, off, dur) in enumerate([("ted_1", 0.0, 0.8), ("ted_1", 0.9, 1.1),
                                          ("ted_2", 0.2, 0.5), ("ted_2", 1.0, 1.7),
                                          ("ted_2", 2.75, 0.25)]):
        segs.append({"wav": f"{talk}.wav", "offset": off, "duration": dur,
                     "speaker_id": f"spk{i % 2}"})
    (split / "txt" / "dev.yaml").write_text(yaml.safe_dump(segs))
    (split / "txt" / "dev.en").write_text("".join(f"source {i}\n" for i in range(5)))
    (split / "txt" / "dev.de").write_text("".join(f"ziel {i}\n" for i in range(5)))
    (root / "spm.model").write_bytes(b"spm")
    (root / "spm.txt").write_text("a 1\n")
    return root


@pytest.mark.parametrize("task", ["wave", "fbank80"])
def test_prep_mustc_writes_the_jax_tools_manifests(mustc, task, tmp_path):
    argv = ["--langs", "de", "--task", task, "--spm-model", str(mustc / "spm.model"),
            "--vocab", str(mustc / "spm.txt")]
    lang = mustc / "en-de"
    jax_prep.main(["--data-root", str(mustc), *argv])
    want = (lang / f"dev_{task}.tsv").read_text()
    want_yaml = (lang / f"config_{'wave' if task == 'wave' else 'fbank'}.yaml").read_text()
    want_feats = {p.name: np.load(p) for p in (lang / "fbank80_dev").glob("*.npy")} \
        if task == "fbank80" else {}
    prep_mustc_data.main(["--data-root", str(mustc), *argv])
    assert (lang / f"dev_{task}.tsv").read_text() == want
    assert (lang / f"config_{'wave' if task == 'wave' else 'fbank'}.yaml").read_text() \
        == want_yaml
    assert len(want.splitlines()) == 6
    for name, feats in want_feats.items():
        np.testing.assert_allclose(np.load(lang / "fbank80_dev" / name), feats, atol=1e-4)


def test_plot_training_reads_the_port_train_log(tmp_path):
    """A two-epoch LM run of the port's train CLI, its log captured; both
    packages' parsers give the same records and the same best epoch, and the
    figure is written."""
    from tests.test_torch_zoo_lm import LM_FLAGS
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(8)
    rows = [" ".join(f"w{i}" for i in rng.integers(0, 15, size=int(rng.integers(3, 9))))
            for _ in range(16)]
    (tmp_path / "train.txt").write_text("\n".join(rows) + "\n")
    preprocess.main(["--only-source", "--trainpref", str(tmp_path / "train.txt"),
                     "--validpref", str(tmp_path / "train.txt"), "--destdir",
                     str(tmp_path / "bin")])
    log = tmp_path / "train.log"
    handler = logging.FileHandler(log)  # the train CLI's own line format
    handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(name)s | "
                                           "%(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        flags = [f for f in LM_FLAGS if f != "--disable-validation"]
        train.main([str(tmp_path / "bin"), *flags, "--vocab-size", "32", "--max-epoch", "2",
                    "--log-interval", "1", "--log-format", "json", "--save-dir",
                    str(tmp_path / "ckpt"), "--no-save", "--device", "cpu"])
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()
    ours, theirs = (m.parse_logs([str(log)]) for m in (plot_training, jax_plot))
    assert ours == theirs and len(ours["valid"]) == 2 and ours["train"]
    stats = tmp_path / "stats.json"
    assert plot_training.main(["-f", str(log), "-i", str(tmp_path / "c.png"), "-l",
                               str(stats), "--stat-types", "loss"]) == 0
    assert (tmp_path / "c.png").stat().st_size > 0
    assert json.loads(stats.read_text())["best"] == list(jax_plot.best_epoch(theirs))


def test_user_dir_registers_a_plugin_criterion(tmp_path):
    plugin = tmp_path / "zoo_plugin"
    plugin.mkdir()
    (plugin / "__init__.py").write_text(
        "from chimera_st_tpu_torch.config.registry import register_criterion\n"
        "@register_criterion('zoo_plugin_xent')\n"
        "def make(cfg):\n    return 'plugin'\n")
    p = options.base_parser("test")
    args, _ = options.parse_with_model_overrides(p, ["data", "--user-dir", str(plugin)])
    from chimera_st_tpu_torch.config.registry import CRITERIONS

    assert CRITERIONS.get("zoo_plugin_xent")({}) == "plugin" and "zoo_plugin" in sys.modules
    options.import_user_module(str(plugin))  # the same path again: a no-op
    with pytest.raises(FileNotFoundError):
        options.import_user_module(str(tmp_path / "missing"))
    other = tmp_path / "elsewhere" / "zoo_plugin"
    other.mkdir(parents=True)
    (other / "__init__.py").write_text("")
    with pytest.raises(ImportError, match="collides"):
        options.import_user_module(str(other))
