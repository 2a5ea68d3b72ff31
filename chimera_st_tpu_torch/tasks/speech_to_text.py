"""Speech-to-text task (counterpart of chimera_st_tpu/tasks/speech_to_text.py)
and its BLEU-validating variant ``speech_to_text_bleu``, whose corpus BLEU
sums over batches as sacrebleu's count buckets."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

from ..config.registry import register_task
from ..data.dictionary import Dictionary
from ..data.manifests import S2TDataConfig, make_dataset_from_tsv
from .base import ChimeraTask

logger = logging.getLogger(__name__)


@register_task("speech_to_text")
class SpeechToTextTask(ChimeraTask):
    def __init__(self, cfg: Dict, tgt_dict: Dictionary, data_cfg: S2TDataConfig):
        super().__init__(cfg)
        self.tgt_dict = tgt_dict
        self.data_cfg = data_cfg

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        data_cfg = S2TDataConfig(str(root / cfg.get("config_yaml", "config_wave.yaml")))
        tgt_dict = cls.load_dictionary(str(root / data_cfg.vocab_filename))
        return cls(cfg, tgt_dict, data_cfg)

    def load_dataset(self, split: str, **kwargs):
        self.datasets[split] = make_dataset_from_tsv(
            self.cfg["data"],
            split,
            self.data_cfg,
            self.tgt_dict,
            split.startswith("train"),
        )

    @property
    def target_dictionary(self) -> Dictionary:
        return self.tgt_dict

    def lang_tag_indices(self):
        """Ids of <lang:xx> tags, stripped from hypotheses before scoring."""
        return {i for s, i in self.tgt_dict.indices.items() if s.startswith("<lang:")}


@register_task("speech_to_text_bleu")
class SpeechToTextBLEUTask(SpeechToTextTask):
    """Beam search during validation, corpus BLEU aggregated from summable
    count buckets (JAX ``tasks/speech_to_text.py:58-104``)."""

    def valid_bleu_counts(self, generator, batch, decode_fn=lambda s: s) -> Dict[str, float]:
        """The sacrebleu count buckets of ``generator``'s best hypotheses
        for the audio ``batch`` (tensors on the generator's device) against
        its targets, ``<lang:xx>`` tags stripped."""
        import sacrebleu

        tokens, _, lens = generator.generate_audio(batch["audio"], batch["audio_padding_mask"])
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        strip = self.lang_tag_indices()
        target = batch["target"].cpu().numpy()
        hyps, refs = [], []
        for b in range(tokens.shape[0]):
            hyps.append(decode_fn(self.tgt_dict.string(
                tokens[b, 0, : lens[b, 0]], bpe_symbol="sentencepiece",
                extra_symbols_to_ignore=strip)))
            refs.append(decode_fn(self.tgt_dict.string(
                target[b], bpe_symbol="sentencepiece", extra_symbols_to_ignore=strip)))
        bleu = sacrebleu.corpus_bleu(hyps, [refs], tokenize="13a")
        return {**{f"_bleu_counts_{i}": c for i, c in enumerate(bleu.counts)},
                **{f"_bleu_totals_{i}": c for i, c in enumerate(bleu.totals)},
                "_bleu_sys_len": bleu.sys_len, "_bleu_ref_len": bleu.ref_len}

    @staticmethod
    def bleu_from_counts(agg: Dict) -> float:
        import sacrebleu

        return sacrebleu.BLEU.compute_bleu(
            correct=[agg[f"_bleu_counts_{i}"] for i in range(4)],
            total=[agg[f"_bleu_totals_{i}"] for i in range(4)],
            sys_len=int(agg["_bleu_sys_len"]), ref_len=int(agg["_bleu_ref_len"]),
            smooth_method="exp").score
