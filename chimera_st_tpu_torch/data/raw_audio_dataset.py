"""Raw-audio datasets (own copy of chimera_st_tpu/data/raw_audio_dataset.py;
fairseq ``raw_audio_dataset.py``, ``add_target_dataset.py``).

- ``RawAudioDataset``: pre-training; the collater crops every utterance to
  one length (the batch's shortest, at most ``max_sample_size``) and samples
  the span masks and the negative indices on the host;
- ``BimodalRawAudioDataset``: two aligned streams (``audio`` / ``audio2``
  columns) cropped over the same window, one mask and one set of negatives;
- ``AddTargetDataset``: ASR fine-tuning; waveforms padded to the batch's
  longest, label ids padded with pad, the eos-rotated decoder input, and the
  fine-tune span mask over the frames of each utterance.

Every crop offset, span and negative comes from one
``np.random.default_rng(seed)`` that lives in the dataset and advances with
each item and batch, drawn call for call as the JAX package draws, so the
batches are array-equal to its over epochs and across a resume. The task
passes no seed, so it is 1 whatever ``--seed`` says (as in JAX; ROADMAP C)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .audio import get_features_or_waveform
from .manifests import load_tsv


class RawAudioDataset:
    def __init__(
        self,
        manifest_rows: List[Dict[str, str]],
        audio_root: str = "",
        max_sample_size: int = 250000,
        min_sample_size: int = 32000,
        mask_prob: float = 0.65,
        mask_length: int = 10,
        num_negatives: int = 100,
        frames_fn=None,  # raw samples -> model frames (conv downsampling)
        seed: int = 1,
    ):
        self.kept_indices = [
            j
            for j, r in enumerate(manifest_rows)
            if int(r["n_frames"]) >= min_sample_size
        ]
        self.rows = [manifest_rows[j] for j in self.kept_indices]
        self.audio_root = audio_root
        self.max_sample_size = max_sample_size
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.num_negatives = num_negatives
        self.frames_fn = frames_fn or (lambda n: n // 320)
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_tsv(cls, path: str, audio_root: str = "", **kw):
        return cls(load_tsv(path), audio_root=audio_root, **kw)

    def __len__(self):
        return len(self.rows)

    def num_tokens(self, i: int) -> int:
        return min(int(self.rows[i]["n_frames"]), self.max_sample_size)

    def __getitem__(self, i: int) -> np.ndarray:
        wav = get_features_or_waveform(
            self.rows[i]["audio"], use_audio_input=True, audio_root=self.audio_root
        )
        if len(wav) > self.max_sample_size:
            # +1: the final valid window is reachable
            start = self.rng.integers(0, len(wav) - self.max_sample_size + 1)
            wav = wav[start : start + self.max_sample_size]
        return wav.astype(np.float32)

    def collater(self, wavs: List[np.ndarray], target_len: Optional[int] = None):
        from ..models.wav2vec2_pretraining import compute_mask_indices, sample_negative_indices

        T = min(min(len(w) for w in wavs), target_len or self.max_sample_size)
        B = len(wavs)
        audio = np.zeros((B, T), np.float32)
        for i, w in enumerate(wavs):
            if len(w) >= T:
                start = self.rng.integers(0, len(w) - T + 1)
                audio[i] = w[start : start + T]
            else:
                audio[i, : len(w)] = w
        frames = self.frames_fn(T)
        mask = compute_mask_indices(
            (B, frames), None, self.mask_prob, self.mask_length, rng=self.rng
        )
        negs = sample_negative_indices(B, frames, self.num_negatives, rng=self.rng)
        return {
            "audio": audio,
            "audio_padding_mask": None,
            "mask_indices": mask,
            "negative_indices": negs,
            "ntokens": float(mask.sum()),
            "nsentences": B,
        }


class BimodalRawAudioDataset(RawAudioDataset):
    """Two ALIGNED waveform streams per row (reference:
    tasks/bimodal_pretraining.py:22-163 + wav2vec2_quasiwave bimodal_forward):
    manifest rows carry ``audio`` and ``audio2`` columns; both streams are
    cropped over the SAME window so frame t of each modality describes the
    same content, and one set of mask/negative indices is shared."""

    def __getitem__(self, i: int):
        row = self.rows[i]
        wav = get_features_or_waveform(
            row["audio"], use_audio_input=True, audio_root=self.audio_root
        ).astype(np.float32)
        wav2 = get_features_or_waveform(
            row["audio2"], use_audio_input=True, audio_root=self.audio_root
        ).astype(np.float32)
        n = min(len(wav), len(wav2))
        if n > self.max_sample_size:
            start = self.rng.integers(0, n - self.max_sample_size + 1)
            n = self.max_sample_size
        else:
            start = 0
        return wav[start : start + n], wav2[start : start + n]

    def num_tokens(self, i: int) -> int:
        r = self.rows[i]
        n = min(int(r["n_frames"]), int(r.get("n_frames2", r["n_frames"])))
        return min(n, self.max_sample_size)

    def collater(self, pairs, target_len: Optional[int] = None):
        from ..models.wav2vec2_pretraining import compute_mask_indices, sample_negative_indices

        T = min(
            min(len(w) for w, _ in pairs), target_len or self.max_sample_size
        )
        B = len(pairs)
        audio = np.zeros((B, T), np.float32)
        audio2 = np.zeros((B, T), np.float32)
        for i, (w, w2) in enumerate(pairs):
            if len(w) >= T:
                start = self.rng.integers(0, len(w) - T + 1)
            else:
                start = 0
            audio[i, : min(T, len(w))] = w[start : start + T]
            audio2[i, : min(T, len(w2))] = w2[start : start + T]
        frames = self.frames_fn(T)
        mask = compute_mask_indices(
            (B, frames), None, self.mask_prob, self.mask_length, rng=self.rng
        )
        negs = sample_negative_indices(B, frames, self.num_negatives, rng=self.rng)
        return {
            "audio": audio,
            "audio2": audio2,
            "audio_padding_mask": None,
            "audio2_padding_mask": None,
            "mask_indices": mask,          # shared across modalities
            "negative_indices": negs,
            "ntokens": float(mask.sum()),
            "nsentences": B,
        }


class AddTargetDataset:
    """Raw-audio dataset + per-utterance label token arrays for ASR
    fine-tuning (reference: fairseq/data/add_target_dataset.py — wraps the
    pretraining dataset with letter/phone targets from ``{split}.{labels}``).

    Unlike the pretraining collater (equal-length crops, no padding), the
    fine-tune collater pads waveforms to the batch max so no labeled frames
    are lost; targets are padded with ``pad_idx`` and ``prev_output_tokens``
    are the eos-rotated inputs for seq2seq decoders."""

    def __init__(
        self,
        base: RawAudioDataset,
        labels: List[np.ndarray],  # int arrays, eos appended
        pad_idx: int = 1,
        eos_idx: int = 2,
    ):
        assert len(base) == len(labels), (len(base), len(labels))
        self.base = base
        self.labels = labels
        self.pad_idx = pad_idx
        self.eos_idx = eos_idx

    def __len__(self):
        return len(self.base)

    def num_tokens(self, i: int) -> int:
        return self.base.num_tokens(i)

    def __getitem__(self, i: int):
        return int(i), self.base[int(i)], self.labels[int(i)]

    def collater(self, items, target_len: Optional[int] = None):
        ids = [i for i, _, _ in items]
        wavs = [w for _, w, _ in items]
        labs = [l for _, _, l in items]
        B = len(wavs)
        T = min(max(len(w) for w in wavs), target_len or self.base.max_sample_size)
        audio = np.zeros((B, T), np.float32)
        pad_mask = np.ones((B, T), bool)
        for i, w in enumerate(wavs):
            n = min(len(w), T)
            audio[i, :n] = w[:n]
            pad_mask[i, :n] = False
        frames = self.base.frames_fn(T)
        # per-utterance frame counts through the conv downsampling
        frame_lens = np.array(
            [self.base.frames_fn(min(len(w), T)) for w in wavs], np.int64
        )
        frame_pad = np.arange(frames)[None, :] >= frame_lens[:, None]
        mask = compute_mask_for_finetune(
            (B, frames), frame_pad, self.base.mask_prob, self.base.mask_length,
            rng=self.base.rng,
        )
        L = max(len(l) for l in labs)
        target = np.full((B, L), self.pad_idx, np.int32)
        prev = np.full((B, L), self.pad_idx, np.int32)
        for i, l in enumerate(labs):
            target[i, : len(l)] = l
            prev[i, 0] = self.eos_idx  # eos-rotated decoder input
            prev[i, 1 : len(l)] = l[:-1]
        return {
            "id": np.asarray(ids, np.int64),
            "audio": audio,
            "audio_padding_mask": pad_mask,
            "audio_lengths": np.minimum(
                np.asarray([len(w) for w in wavs], np.int64), T
            ),
            "mask_indices": mask,
            "target": target,
            "prev_output_tokens": prev,
            "ntokens": float(sum(len(l) for l in labs)),
            "nsentences": B,
        }


def compute_mask_for_finetune(shape, frame_padding_mask, mask_prob, mask_length, rng):
    from ..models.wav2vec2_pretraining import compute_mask_indices

    return compute_mask_indices(
        shape, frame_padding_mask, mask_prob, mask_length, rng=rng
    )
