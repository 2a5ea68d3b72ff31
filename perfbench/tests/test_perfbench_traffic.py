"""The mixes against the public tables they name: each derived number is
the table's arithmetic, and the generated sizes keep to it."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import traffic  # noqa: E402

MIXES = sorted((ROOT / "perfbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_mix_names_its_source(path):
    mix = json.loads(path.read_text())
    assert mix["source"].startswith("https://") and mix["source_table"]
    assert set(mix["derived"]).isdisjoint(mix["assumed"])


def test_st_finetune_is_must_c_en_de():
    mix = json.loads((ROOT / "perfbench" / "traffic" / "st_finetune.json").read_text())
    audio_s = 408 * 3600  # MuST-C Table 1, En-De: 408 h, 234K segments, 2,093 talks
    assert mix["seconds"]["mean"] == pytest.approx(audio_s / 234e3, abs=1e-4)
    assert mix["src_tokens_per_s"] == pytest.approx(4.3e6 / audio_s, abs=1e-4)
    assert mix["tgt_tokens_per_s"] == pytest.approx(4.0e6 / audio_s, abs=1e-4)
    assert mix["talk_utterances"] == round(234e3 / 2093)
    sz = traffic.sizes(mix)
    sec = sz["samples"] / traffic.SAMPLE_RATE
    assert sec.mean() == pytest.approx(mix["seconds"]["mean"], rel=0.02)
    assert sec.min() >= mix["seconds"]["min"] and sec.max() <= mix["seconds"]["max"]
    assert sz["src"].sum() / sec.sum() == pytest.approx(mix["src_tokens_per_s"], rel=0.02)
    assert sz["tgt"].sum() / sec.sum() == pytest.approx(mix["tgt_tokens_per_s"], rel=0.02)


def test_sizes_come_from_the_mix_not_the_run():
    mix = json.loads((ROOT / "perfbench" / "traffic" / "st_finetune.json").read_text())
    mix["utterances"] = 50
    a, b = traffic.generate(mix, 100, 100, 1), traffic.generate(mix, 100, 100, 2 ** 33 + 1)
    assert np.array_equal(a.samples, b.samples)
    assert [len(x) for x in a.tgt] == [len(x) for x in b.tgt]
    assert not np.array_equal(a.audio[0], b.audio[0])
