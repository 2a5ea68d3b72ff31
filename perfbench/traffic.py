"""The one generator of traffic: a mix file (``traffic/<name>.json``) of
parameters becomes utterances, their transcripts and translations, written
as a MuST-C data directory that the port's task reads.

- The sizes (each utterance's duration, and its source and target token
  counts) are drawn from the mix's own ``size_seed``, and the cells shuffle
  their batches with it too, so every run of a cell meets the same batches
  in the same order and does the same work in its window; the run's
  ``--seed`` draws the content (audio samples, token ids), the weights and
  the dropout masks.
- Durations are lognormal with the mix's ``mean`` and ``sigma`` (of the
  log), clipped to [``min``, ``max``] seconds; token counts are Poisson
  around ``*_tokens_per_s`` times the duration, at least 1. A mix names the
  public table its numbers come from (``source``) and lists what that table
  does not give (``assumed``).
- Token ids follow a Zipf law (``zipf_exponent``) over the dictionary's
  words.
- Audio is int16 PCM at 16 kHz, uniform noise, stored as MuST-C stores it:
  one wav a talk of ``talk_utterances`` segments, each addressed as
  ``wav:offset:length`` in the manifest.
"""

from __future__ import annotations

import json
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

SAMPLE_RATE = 16000
SPECIALS = 4  # <s> <pad> </s> <unk>


@dataclass
class Utterances:
    """A generated set: ``samples[i]`` audio samples, ``audio[i]`` int16 PCM,
    ``src[i]`` / ``tgt[i]`` word ids without eos (dictionary indices)."""

    samples: np.ndarray
    audio: List[np.ndarray]
    src: List[np.ndarray]
    tgt: List[np.ndarray]

    @property
    def seconds(self) -> np.ndarray:
        return self.samples / SAMPLE_RATE


def zipf_rows(rng, n_words: int, exponent: float, lengths: np.ndarray) -> List[np.ndarray]:
    """Rows of Zipf-drawn word ranks (0 = the most frequent), one a length.
    The sampling pattern of ``chip_smoke.py`` ``zipf_rows``, over ranks."""
    p = 1.0 / np.arange(1, n_words + 1) ** exponent
    p /= p.sum()
    ids = rng.choice(n_words, size=int(lengths.sum()), p=p)
    return np.split(ids, np.cumsum(lengths)[:-1])


def sizes(mix: Dict) -> Dict[str, np.ndarray]:
    """The mix's sizes from its ``size_seed``: samples, source and target
    token counts a row."""
    rng = np.random.default_rng(int(mix["size_seed"]))
    d = mix["seconds"]
    n = int(mix["utterances"])
    mu = np.log(d["mean"]) - d["sigma"] ** 2 / 2  # a lognormal's mean is exp(mu + sigma^2 / 2)
    sec = np.clip(rng.lognormal(mu, d["sigma"], n), d["min"], d["max"])
    samples = np.round(sec * SAMPLE_RATE).astype(np.int64)
    src = np.maximum(rng.poisson(mix["src_tokens_per_s"] * sec), 1)
    tgt = np.maximum(rng.poisson(mix["tgt_tokens_per_s"] * sec), 1)
    return {"samples": samples, "src": src, "tgt": tgt}


def generate(mix: Dict, src_vocab: int, tgt_vocab: int, seed: int) -> Utterances:
    """The utterances of ``mix`` with their content drawn from ``seed``."""
    sz = sizes(mix)
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 0x7EAF])
    samples, src_len, tgt_len = sz["samples"], sz["src"], sz["tgt"]
    amp = int(mix.get("amplitude", 3277))
    flat = rng.integers(-amp, amp + 1, size=int(samples.sum()), dtype=np.int16)
    audio = np.split(flat, np.cumsum(samples)[:-1])
    words = lambda vocab, lens: [r + SPECIALS for r in zipf_rows(rng, vocab - SPECIALS,
                                                                  mix["zipf_exponent"], lens)]
    return Utterances(samples, audio, words(src_vocab, src_len), words(tgt_vocab, tgt_len))


def _write_wav(path: Path, pcm: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.astype("<i2").tobytes())


def _dictionary(path: Path, vocab: int) -> None:
    path.write_text("".join(f"w{i} 1\n" for i in range(SPECIALS, vocab)))


def word(i: int) -> str:
    """The dictionary word of index i (the benchmark's dictionaries list
    ``w4`` ... ``w{V-1}`` after the four special symbols)."""
    return f"w{i}"


def write_dataset(root: Path, split: str, utts: Utterances, mix: Dict, src_vocab: int,
                  tgt_vocab: int) -> Path:
    """Writes the wavs (one a talk), ``{split}.tsv``, the dictionaries and
    ``config_wave.yaml`` (JSON, which is YAML) under ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "wavs").mkdir(exist_ok=True)
    per_talk = int(mix.get("talk_utterances", 150))
    rows = []
    for t0 in range(0, len(utts.samples), per_talk):
        name = f"wavs/talk{t0 // per_talk}.wav"
        segs = utts.audio[t0:t0 + per_talk]
        _write_wav(root / name, np.concatenate(segs))
        offset = 0
        for j, seg in enumerate(segs):
            i = t0 + j
            src = " ".join(word(int(w)) for w in utts.src[i])
            tgt = " ".join(word(int(w)) for w in utts.tgt[i])
            rows.append(f"u{i}\t{name}:{offset}:{len(seg)}\t{len(seg)}\t{src}\t{tgt}\n")
            offset += len(seg)
    (root / f"{split}.tsv").write_text("id\taudio\tn_frames\tsrc_text\ttgt_text\n"
                                       + "".join(rows))
    _dictionary(root / "dict.txt", tgt_vocab)
    _dictionary(root / "src_dict.txt", src_vocab)
    cfg = {"audio_root": str(root), "use_audio_input": True, "vocab_filename": "dict.txt",
           "src_vocab_filename": "src_dict.txt"}
    (root / "config_wave.yaml").write_text(json.dumps(cfg))
    return root
