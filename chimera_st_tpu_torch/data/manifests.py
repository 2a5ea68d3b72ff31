"""Speech-to-text datasets over TSV manifests (own copy of
chimera_st_tpu/data/manifests.py):

- `S2TDataConfig` / `TripletDataConfig`: the per-datadir ``config_wave.yaml``
  schema (audio_root, vocab_filename, bpe_tokenizer, src_bpe_tokenizer,
  use_audio_input, prepend_tgt_lang_tag, sampling_alpha, transforms),
- manifest columns: id / audio / n_frames / tgt_text / speaker (+ src_text
  for triplet; reference: chimera/prepare_data/prep_mustc_data.py:122-125);
  for `--task wave` manifests the audio column is ``path:offset:length`` and
  n_frames is the raw sample count,
- collaters pad to the bucket lengths the task hands them, as the JAX
  package's do,
- comma-joined splits, concatenated, with temperature resampling
  (``sampling_alpha``) of training splits each epoch,
- the training wire format (``set_wire_format``): int16 PCM and no padding
  mask in a batch, rebuilt on the card.

``config_wave.yaml`` is read with ``yaml`` where that is installed and as JSON
(which is YAML) where it is not. Features (``use_audio_input`` false) go
through the split's feature transforms (``feature_transforms.py``: SpecAugment,
CMVN), whose parameters sit at the top level of the config, as the
reference's ``gen_config_yaml`` writes them.
"""

from __future__ import annotations

import csv
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from .audio import get_features_or_waveform
from .batching import collate_tokens
from .dictionary import Dictionary
from .encoders import build_bpe, build_tokenizer

logger = logging.getLogger(__name__)


class S2TDataConfig:
    """Wrapper for config_wave.yaml."""

    def __init__(self, yaml_path: str):
        self.config: Dict = {}
        p = Path(yaml_path)
        if p.is_file():
            text = p.read_text()
            try:
                import yaml
            except ImportError:
                import json

                try:
                    self.config = json.loads(text) if text.strip() else {}
                except json.JSONDecodeError as e:
                    raise RuntimeError(
                        f"{yaml_path}: the yaml package is not installed, and without it "
                        f"a data config must be written as JSON ({e})") from e
            else:
                self.config = yaml.safe_load(text) or {}
        else:
            logger.warning(f"data config not found: {yaml_path}")
        self._root = str(p.parent)

    @property
    def vocab_filename(self) -> str:
        return self.config.get("vocab_filename", "dict.txt")

    @property
    def shuffle(self) -> bool:
        return bool(self.config.get("shuffle", False))

    @property
    def pre_tokenizer(self) -> Dict:
        return self.config.get("pre_tokenizer", {"tokenizer": None})

    @property
    def bpe_tokenizer(self) -> Dict:
        return self.config.get("bpe_tokenizer", {"bpe": None})

    @property
    def prepend_tgt_lang_tag(self) -> bool:
        return bool(self.config.get("prepend_tgt_lang_tag", False))

    @property
    def input_feat_per_channel(self) -> int:
        return int(self.config.get("input_feat_per_channel", 80))

    @property
    def input_channels(self) -> int:
        return int(self.config.get("input_channels", 1))

    @property
    def sampling_alpha(self) -> float:
        return float(self.config.get("sampling_alpha", 1.0))

    @property
    def use_audio_input(self) -> bool:
        return bool(self.config.get("use_audio_input", False))

    @property
    def audio_root(self) -> str:
        return self.config.get("audio_root", "")

    def get_feature_transforms(self, split: str, is_train: bool):
        cfg = dict(self.config.get("transforms", {}) or {})
        # exact split key first, then the _train/_eval wildcards, then *
        cur = cfg.get(split)
        if cur is None and is_train:
            cur = cfg.get("_train")
        if cur is None and not is_train:
            cur = cfg.get("_eval")
        if cur is None:
            cur = cfg.get("*")
        return cur


class TripletDataConfig(S2TDataConfig):
    @property
    def src_bpe_tokenizer(self) -> Dict:
        return self.config.get("src_bpe_tokenizer", {"bpe": None})

    @property
    def src_vocab_filename(self) -> str:
        return self.config.get("src_vocab_filename", "dict.txt")


def _bpe_cfg_to_registry(cfg: Dict) -> Optional[Dict]:
    """{'bpe': name, ...} -> {'_name': name, ...} registry form."""
    if not cfg:
        return None
    name = cfg.get("bpe") or cfg.get("_name")
    if not name:
        return None
    out = dict(cfg)
    out["_name"] = name
    return out


def _tok_cfg_to_registry(cfg: Dict) -> Optional[Dict]:
    if not cfg:
        return None
    name = cfg.get("tokenizer") or cfg.get("_name")
    if not name:
        return None
    out = dict(cfg)
    out["_name"] = name
    return out


def load_tsv(path: str) -> List[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        reader = csv.DictReader(
            f,
            delimiter="\t",
            quotechar=None,
            doublequote=False,
            lineterminator="\n",
            quoting=csv.QUOTE_NONE,
        )
        return [dict(row) for row in reader]


@dataclass
class S2TExample:
    index: int
    audio: np.ndarray  # waveform [T] or features [T, F]
    target: Optional[np.ndarray]  # tgt token ids (with eos)
    source_text: Optional[np.ndarray] = None  # src token ids (with eos)


class SpeechToTextDataset:
    """(audio, tgt_text) pairs of one manifest."""

    LANG_TAG_TEMPLATE = "<lang:{}>"

    def __init__(
        self,
        split: str,
        is_train_split: bool,
        data_cfg: S2TDataConfig,
        audio_paths: List[str],
        n_frames: List[int],
        tgt_texts: Optional[List[str]] = None,
        tgt_dict: Optional[Dictionary] = None,
        tgt_langs: Optional[List[str]] = None,
        ids: Optional[List[str]] = None,
    ):
        self.split = split
        self.is_train_split = is_train_split
        self.cfg = data_cfg
        self.audio_paths = audio_paths
        self.n_frames = np.asarray(n_frames, dtype=np.int64)
        self.tgt_texts = tgt_texts
        self.tgt_dict = tgt_dict
        self.tgt_langs = tgt_langs
        self.ids = ids or [str(i) for i in range(len(audio_paths))]
        self.pre_tokenizer = build_tokenizer(
            _tok_cfg_to_registry(data_cfg.pre_tokenizer)
        )
        self.bpe = build_bpe(_bpe_cfg_to_registry(data_cfg.bpe_tokenizer))
        # fbank-mode feature transforms (specaugment/cmvn); wave mode has none.
        # Each transform's parameters live at the top level of the config
        from .feature_transforms import CompositeAudioFeatureTransform

        tf_list = data_cfg.get_feature_transforms(split, is_train_split)
        self.feature_transforms = (
            CompositeAudioFeatureTransform.from_config_dict(
                {**{k: v for k, v in data_cfg.config.items() if k != "transforms"},
                 "transforms": tf_list})
            if tf_list and not data_cfg.use_audio_input else None)
        self.pad = tgt_dict.pad() if tgt_dict else 1
        self.eos = tgt_dict.eos() if tgt_dict else 2
        # the training wire format (set_wire_format, the train split only):
        # wire_int16 keeps PCM16 waveforms int16 from the decode cache to the
        # card, device_mask leaves the [B, T] padding mask out of the batch;
        # train_step.prepare_batch rebuilds both on the card
        self.wire_int16 = False
        self.device_mask = False
        if data_cfg.prepend_tgt_lang_tag and tgt_dict is not None and tgt_langs:
            for lang in sorted(set(tgt_langs)):
                tag = self.LANG_TAG_TEMPLATE.format(lang)
                if tag not in tgt_dict.indices:
                    raise ValueError(f"lang tag {tag} missing from dict")

    def __len__(self):
        return len(self.audio_paths)

    def num_tokens(self, index: int) -> int:
        return int(self.n_frames[index])

    def tokenize_text(self, text: str, bpe=None, pre=None) -> str:
        pre = pre if pre is not None else self.pre_tokenizer
        bpe = bpe if bpe is not None else self.bpe
        if pre is not None:
            text = pre.encode(text)
        if bpe is not None:
            text = bpe.encode(text)
        return text

    def _get_tgt_tokens(self, index: int) -> Optional[np.ndarray]:
        if self.tgt_texts is None or self.tgt_dict is None:
            return None
        tokenized = self.tokenize_text(self.tgt_texts[index])
        ids = self.tgt_dict.encode_line(tokenized, append_eos=True)
        if self.cfg.prepend_tgt_lang_tag and self.tgt_langs:
            tag = self.LANG_TAG_TEMPLATE.format(self.tgt_langs[index])
            ids = np.concatenate([[self.tgt_dict.index(tag)], ids]).astype(np.int32)
        return ids

    def __getitem__(self, index: int) -> S2TExample:
        audio = get_features_or_waveform(
            self.audio_paths[index],
            use_audio_input=self.cfg.use_audio_input,
            audio_root=self.cfg.audio_root,
            int16=(self.wire_int16 and self.cfg.use_audio_input
                   and self.feature_transforms is None),
        )
        if audio.dtype != np.int16:  # features, or a wav that is not mono PCM16
            audio = audio.astype(np.float32)
            if self.feature_transforms is not None:
                audio = self.feature_transforms(audio)
        return S2TExample(index, audio, self._get_tgt_tokens(index))

    # --------------------------------------------------------------- collate

    @staticmethod
    def _collate_order(samples: List[S2TExample]) -> List[S2TExample]:
        """THE batch order (descending n-frames, stable): the single key
        definition every collater (base + triplet src_text rows) sorts by,
        so modality rows can never silently misalign."""
        return sorted(samples, key=lambda s: -len(s.audio))

    def collater(
        self,
        samples: List[S2TExample],
        audio_target_len: Optional[int] = None,
        text_target_len: Optional[int] = None,
    ) -> Dict[str, Any]:
        if not samples:
            return {}
        # sort by descending n-frames (reference collater order)
        samples = self._collate_order(samples)
        if all(s.audio.dtype == np.int16 for s in samples):
            audio = collate_tokens([s.audio for s in samples], 0, target_len=audio_target_len,
                                   dtype=np.int16)
        else:
            audio = collate_tokens(
                [s.audio.astype(np.float32) / 32768.0 if s.audio.dtype == np.int16 else s.audio
                 for s in samples], 0.0, target_len=audio_target_len, dtype=np.float32)
        lengths = np.asarray([len(s.audio) for s in samples], np.int32)
        batch = {
            "id": np.asarray([s.index for s in samples], np.int64),
            "audio": audio,
            "audio_lengths": lengths,
            "nsentences": len(samples),
        }
        if not self.device_mask:
            pos = np.arange(audio.shape[1])[None, :]
            batch["audio_padding_mask"] = pos >= lengths[:, None]
        if samples[0].target is not None:
            tgt = collate_tokens(
                [s.target for s in samples], self.pad, target_len=text_target_len,
                dtype=np.int32,
            )
            prev = collate_tokens(
                [np.concatenate([[self.eos], s.target[:-1]]) for s in samples],
                self.pad,
                target_len=text_target_len,
                dtype=np.int32,
            )
            batch["target"] = tgt
            batch["prev_output_tokens"] = prev
            batch["target_lengths"] = np.asarray(
                [len(s.target) for s in samples], np.int32
            )
            batch["ntokens"] = float(sum(len(s.target) for s in samples))
        else:
            batch["ntokens"] = float(sum(len(s.audio) for s in samples))
        return batch


class TripletDataset(SpeechToTextDataset):
    """(audio, src_text, tgt_text) triplets."""

    def __init__(
        self,
        *args,
        src_texts: Optional[List[str]] = None,
        src_dict: Optional[Dictionary] = None,
        src_bpe=None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.src_texts = src_texts
        self.src_dict = src_dict
        self.src_bpe = src_bpe

    def _get_src_tokens(self, index: int) -> Optional[np.ndarray]:
        if self.src_texts is None or self.src_dict is None:
            return None
        text = self.src_texts[index]
        if self.pre_tokenizer is not None:
            text = self.pre_tokenizer.encode(text)
        if self.src_bpe is not None:
            text = self.src_bpe.encode(text)
        return self.src_dict.encode_line(text, append_eos=True)

    def __getitem__(self, index: int) -> S2TExample:
        ex = super().__getitem__(index)
        ex.source_text = self._get_src_tokens(index)
        return ex

    def collater(
        self,
        samples: List[S2TExample],
        audio_target_len: Optional[int] = None,
        text_target_len: Optional[int] = None,
        src_target_len: Optional[int] = None,
    ) -> Dict[str, Any]:
        batch = super().collater(samples, audio_target_len, text_target_len)
        if not batch:
            return batch
        # the same order the parent used: src_text rows align with audio rows
        samples = self._collate_order(samples)
        if samples[0].source_text is not None:
            src = collate_tokens(
                [s.source_text for s in samples],
                self.src_dict.pad() if self.src_dict else 1,
                target_len=src_target_len,
                dtype=np.int32,
            )
            batch["src_text"] = src
            batch["src_text_lengths"] = np.asarray(
                [len(s.source_text) for s in samples], np.int32
            )
        return batch


def set_wire_format(dataset, int16: bool = True, device_mask: bool = True):
    """Sets the training wire format (``wire_int16``, ``device_mask``) on
    every ``SpeechToTextDataset`` under ``dataset``, through the concat,
    resampling and joint wrappers (their ``datasets`` list or dict, their
    ``dataset``). ``cli.train`` sets it on the train split unless
    ``--no-host-wire``; ``train_step.prepare_batch`` undoes both on the
    card."""
    seen = set()

    def walk(ds):
        if ds is None or id(ds) in seen:
            return
        seen.add(id(ds))
        if isinstance(ds, SpeechToTextDataset):
            ds.wire_int16 = bool(int16)
            ds.device_mask = bool(device_mask)
        subs = getattr(ds, "datasets", None)
        if isinstance(subs, dict):
            subs = list(subs.values())
        if isinstance(subs, (list, tuple)):
            for sub in subs:
                walk(sub)
        inner = getattr(ds, "dataset", None)
        if inner is not None and not callable(inner):
            walk(inner)

    walk(dataset)


def resample_sizes(sizes, alpha: float) -> np.ndarray:
    """Temperature resampling ratios over splits: each split's share of the
    samples raised to ``alpha``, renormalised, over its share."""
    sizes = np.asarray(sizes, np.float64)
    probs = sizes / sizes.sum()
    smoothed = probs ** alpha
    smoothed /= smoothed.sum()
    return smoothed / probs


def make_dataset_from_tsv(
    root: str,
    split: str,
    data_cfg: S2TDataConfig,
    tgt_dict: Optional[Dictionary],
    is_train: bool,
    src_dict: Optional[Dictionary] = None,
    triplet: bool = False,
    seed: int = 1,
    epoch: int = 1,
):
    """Build the dataset of ``split`` (``{root}/{split}.tsv``). Comma-joined
    splits are concatenated; for training, with ``sampling_alpha`` other
    than 1, each is resampled every epoch to its temperature ratio
    (``resample_sizes``), drawn from ``(seed, epoch)``."""
    splits = split.split(",")
    if len(splits) > 1:
        from .wrappers import ConcatDataset, ResamplingDataset

        datasets = [make_dataset_from_tsv(root, s, data_cfg, tgt_dict, is_train,
                                          src_dict=src_dict, triplet=triplet, seed=seed,
                                          epoch=epoch) for s in splits]
        if is_train and data_cfg.sampling_alpha != 1.0:
            ratios = resample_sizes([len(d) for d in datasets], data_cfg.sampling_alpha)
            logger.info("balanced sampling size ratios: "
                        + str({s: f"{r:.3f}" for s, r in zip(splits, ratios)}))
            datasets = [ResamplingDataset(d, size_ratio=r, seed=seed, epoch=epoch,
                                          replace=(r >= 1.0)) for d, r in zip(datasets, ratios)]
        return ConcatDataset(datasets)
    rows = load_tsv(str(Path(root) / f"{split}.tsv"))
    audio_paths = [r["audio"] for r in rows]
    n_frames = [int(r["n_frames"]) for r in rows]
    # a manifest without a tgt_text column has no labels (inference manifests)
    tgt_texts = (
        [r["tgt_text"] for r in rows]
        if rows and "tgt_text" in rows[0] else None
    )
    ids = [r.get("id", str(i)) for i, r in enumerate(rows)]
    tgt_langs = [r["tgt_lang"] for r in rows] if "tgt_lang" in (rows[0] if rows else {}) else None
    if triplet:
        cfg = data_cfg if isinstance(data_cfg, TripletDataConfig) else None
        src_bpe = build_bpe(
            _bpe_cfg_to_registry(cfg.src_bpe_tokenizer) if cfg else None
        )
        return TripletDataset(
            split,
            is_train,
            data_cfg,
            audio_paths,
            n_frames,
            tgt_texts=tgt_texts,
            tgt_dict=tgt_dict,
            tgt_langs=tgt_langs,
            ids=ids,
            src_texts=[r.get("src_text", "") for r in rows],
            src_dict=src_dict,
            src_bpe=src_bpe,
        )
    return SpeechToTextDataset(
        split,
        is_train,
        data_cfg,
        audio_paths,
        n_frames,
        tgt_texts=tgt_texts,
        tgt_dict=tgt_dict,
        tgt_langs=tgt_langs,
        ids=ids,
    )
