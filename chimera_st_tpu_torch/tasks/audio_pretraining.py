"""``audio_pretraining`` and ``bimodal_pretraining`` (counterpart of
chimera_st_tpu/tasks/audio_pretraining.py; fairseq ``audio_pretraining``,
Chimera's ``bimodal_pretraining``).

Without ``--labels`` the task pre-trains on raw audio: the model is
``Wav2Vec2PretrainModel`` whatever ``--arch`` names, from the model config
as given, no preset applied (as in JAX: ``--arch wav2vec2_large`` builds
the base widths, ROADMAP C). With ``--labels ltr`` it fine-tunes for speech
recognition: targets are the lines of ``{split}.ltr`` encoded with
``dict.ltr.txt`` (eos appended under ``--autoregressive``, for
``wav2vec_seq2seq``), and the model comes from the registry
(``wav2vec_ctc`` / ``wav2vec_seq2seq``). ``bimodal_pretraining`` reads two
aligned streams a row (``audio`` and ``audio2`` manifest columns).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch

from ..config.registry import register_task
from ..data.raw_audio_dataset import AddTargetDataset, BimodalRawAudioDataset, RawAudioDataset
from .base import ChimeraTask


@register_task("audio_pretraining")
class AudioPretrainingTask(ChimeraTask):
    DATASET_CLS = RawAudioDataset

    def __init__(self, cfg: Dict):
        super().__init__(cfg)
        self._label_dict = None
        if cfg.get("labels"):
            self._label_dict = self.load_dictionary(
                str(Path(cfg["data"]) / f"dict.{cfg['labels']}.txt"))

    @property
    def target_dictionary(self):
        return self._label_dict

    def load_dataset(self, split: str, **kwargs):
        from ..models.wav2vec2 import DEFAULT_CONV_SPEC, extractor_output_length

        conv_spec = tuple(map(tuple, self.cfg.get("conv_spec") or self.cfg.get("w2v2_conv_spec")
                              or DEFAULT_CONV_SPEC))
        root = Path(self.cfg["data"])
        base = self.DATASET_CLS.from_tsv(
            str(root / f"{split}.tsv"),
            audio_root=self.cfg.get("audio_root", str(root)),
            max_sample_size=int(self.cfg.get("max_sample_size", 250000)),
            min_sample_size=int(self.cfg.get("min_sample_size", 32000)),
            mask_prob=float(self.cfg.get("mask_prob", 0.65)),
            mask_length=int(self.cfg.get("mask_length", 10)),
            num_negatives=int(self.cfg.get("num_negatives", 100)),
            frames_fn=lambda n: extractor_output_length(n, conv_spec),
        )
        if not self.cfg.get("labels"):
            self.datasets[split] = base
            return
        append_eos = bool(self.cfg.get("autoregressive", False))
        with open(root / f"{split}.{self.cfg['labels']}") as f:
            labels = [self._label_dict.encode_line(line, append_eos=append_eos) for line in f]
        self.datasets[split] = AddTargetDataset(
            base, [labels[j] for j in base.kept_indices], pad_idx=self._label_dict.pad(),
            eos_idx=self._label_dict.eos())

    def build_model(self, model_cfg: Dict, dtype=torch.float32, device="cuda",
                    train: bool = False):
        if self.cfg.get("labels"):
            return super().build_model(model_cfg, dtype, device, train)
        from ..models.layers import cast_compute_dtype_
        from ..models.wav2vec2_pretraining import build_w2v2_pretrain

        if train and dtype != torch.float32:
            raise ValueError("a model built for training keeps fp32 parameters; "
                             "run bf16 compute under torch.autocast")
        model = build_w2v2_pretrain(dict(model_cfg), device=device)
        if train:
            return model.train()
        return cast_compute_dtype_(model.eval(), dtype)

    def collate_indices(self, dataset, idx, audio_target_len):
        return dataset.collater([dataset[int(i)] for i in idx], audio_target_len)


@register_task("bimodal_pretraining")
class BimodalPretrainingTask(AudioPretrainingTask):
    DATASET_CLS = BimodalRawAudioDataset
