"""Triplet task: (audio, src_text, tgt_text) speech translation (counterpart
of chimera_st_tpu/tasks/triplet.py).

Data dir layout: ``{data}/config_wave.yaml`` + ``{split}.tsv`` manifests +
vocab files. Interactive inference consumes .wav file paths.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..config.registry import register_task
from ..data.audio import read_wav
from ..data.batching import round16_or_none
from ..data.dictionary import Dictionary
from ..data.manifests import TripletDataConfig, make_dataset_from_tsv
from .base import ChimeraTask

logger = logging.getLogger(__name__)


@register_task("triplet")
class TripletTask(ChimeraTask):
    def __init__(self, cfg: Dict, tgt_dict: Dictionary, src_dict: Dictionary, data_cfg):
        super().__init__(cfg)
        self.tgt_dict = tgt_dict
        self.src_dict = src_dict
        self.data_cfg = data_cfg

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        data_cfg = TripletDataConfig(str(root / cfg.get("config_yaml", "config_wave.yaml")))
        tgt_dict = cls.load_dictionary(str(root / data_cfg.vocab_filename))
        src_dict = cls.load_dictionary(str(root / data_cfg.src_vocab_filename))
        logger.info(f"triplet task: tgt dict {len(tgt_dict)}, src dict {len(src_dict)}")
        return cls(cfg, tgt_dict, src_dict, data_cfg)

    def load_dataset(self, split: str, **kwargs):
        self.datasets[split] = make_dataset_from_tsv(
            self.cfg["data"],
            split,
            self.data_cfg,
            self.tgt_dict,
            split.startswith("train"),
            src_dict=self.src_dict,
            triplet=True,
            seed=int(self.cfg.get("seed", 1)),
        )

    @property
    def source_dictionary(self) -> Dictionary:
        return self.src_dict

    @property
    def target_dictionary(self) -> Dictionary:
        return self.tgt_dict

    def collate_indices(self, dataset, idx, audio_target_len):
        samples = [dataset[int(i)] for i in idx]
        # text lengths padded to multiples of 16, as the JAX package's batches
        tgt_max = max(len(s.target) for s in samples) if samples[0].target is not None else 0
        src_max = (
            max(len(s.source_text) for s in samples)
            if samples[0].source_text is not None
            else 0
        )
        return dataset.collater(
            samples,
            audio_target_len=audio_target_len,
            text_target_len=round16_or_none(tgt_max),
            src_target_len=round16_or_none(src_max),
        )

    def dump_memories(self, model, batch) -> Dict[str, np.ndarray]:
        """The audio and (where the batch has source text) text memory banks
        of a prepared batch, as fp32 numpy arrays (``--dump-feature-to-file``
        of the validate CLI)."""
        audio_mem, _ = model.encode_audio(batch["audio"], batch["audio_padding_mask"])
        out = {"audio_memory": audio_mem.float().cpu().numpy()}
        if "src_text" in batch:
            text_mem, _ = model.encode_text(batch["src_text"])
            out["text_memory"] = text_mem.float().cpu().numpy()
        return out

    # ------------------------------------------------------- interactive

    def get_interactive_examples(self, lines: List[str]):
        """Lines are .wav paths."""
        return [read_wav(line.strip())[0].astype(np.float32) for line in lines]

    def batch_interactive(self, wavs: List[np.ndarray]):
        T = max(len(w) for w in wavs)
        T = ((T + 1279) // 1280) * 1280  # a multiple of four wav2vec2 strides
        audio = np.zeros((len(wavs), T), np.float32)
        mask = np.ones((len(wavs), T), bool)
        for i, w in enumerate(wavs):
            audio[i, : len(w)] = w
            mask[i, : len(w)] = False
        return {"audio": audio, "audio_padding_mask": mask,
                "audio_lengths": np.asarray([len(w) for w in wavs], np.int32)}


@register_task("speech_to_text_triplet_infer")
class TripletInferenceTask(TripletTask):
    """Alias used by interactive configs."""
