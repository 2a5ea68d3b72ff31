"""Translation with language tokens (counterpart of part of
chimera_st_tpu/tasks/translation_extra.py):

- ``translation_from_pretrained_bart`` (fairseq
  ``tasks/translation_from_pretrained_bart.py``): mBART fine-tuning. The
  dictionaries gain a ``[lang]`` symbol for each of ``--langs``, then
  ``<mask>``; the source is suffixed with ``[src]``, the target with
  ``[tgt]``, and ``[tgt]`` leads ``prev_output_tokens``. The generator
  starts from eos and stops at eos, as the JAX package's (fairseq's task
  makes ``[tgt]`` the generator's eos: ROADMAP C); the generate CLI strips
  the ``[lang]`` symbols from what it prints (``lang_tag_indices``).
- ``translation_multi_simple_epoch`` (fairseq
  ``tasks/translation_multi_simple_epoch.py``): many-to-many translation
  with one shared model and one dictionary over ``--lang-pairs``, a
  ``__lang__`` symbol a language, the encoder's language token
  (``--encoder-langtok src|tgt``, default ``tgt``) prepended to the source
  and with ``--decoder-langtok`` the target's leading
  ``prev_output_tokens``; on the train split the pairs are resampled each
  epoch by ``--sampling-temperature`` (p^(1/T)) or ``--sampling-alpha``
  (p^a) through ``ResamplingDataset``.

- ``translation_from_pretrained_xlm`` (fairseq
  ``tasks/translation_from_pretrained_xlm.py``): translation whose encoder
  starts from a masked-LM (XLM) checkpoint: ``post_init_params`` reads
  ``--pretrained-xlm-checkpoint`` (a ``.ckpt`` of either package) and
  copies its embeddings and layers in through
  ``init_transformer_from_pretrained_xlm`` (the decoder's embeddings too
  with ``--init-decoder``). As in JAX, the dictionaries are the translation
  task's: the embeddings are copied only where their sizes agree.
- ``semisupervised_translation`` (fairseq
  ``tasks/semisupervised_translation.py``): the parallel pairs mixed with
  denoising-autoencoder pairs (``NoisingDataset`` of the target side's
  monolingual split, or of the parallel target side where there is none,
  word shuffle ``--word-shuffle`` then word dropout ``--word-dropout``)
  at the ratios of ``--lambda-parallel`` / ``--lambda-denoising``, drawn
  per epoch through ``ResamplingDataset``. As in JAX the lambdas weigh the
  data, not the losses; the batches take the parallel data's collater.
"""

from __future__ import annotations

from pathlib import Path
import logging
from typing import Callable, Dict, List, Optional

import numpy as np

from ..config.registry import register_task
from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.language_pair import LanguagePairDataset
from ..data.wrappers import IdStampedConcat, ResamplingDataset
from .base import ChimeraTask
from .translation import TranslationTask, collate_pairs

logger = logging.getLogger(__name__)


class LangTokPairDataset:
    """A language-pair dataset with language tokens: ``src_prepend`` /
    ``src_append`` around the source, ``tgt_append`` after the target, and
    ``tgt_bos`` in place of the eos that leads ``prev_output_tokens``."""

    def __init__(self, base: LanguagePairDataset, src_prepend: Optional[int] = None,
                 src_append: Optional[int] = None, tgt_bos: Optional[int] = None,
                 tgt_append: Optional[int] = None):
        self.base = base
        self.src_prepend = src_prepend
        self.src_append = src_append
        self.tgt_bos = tgt_bos
        self.tgt_append = tgt_append

    def __len__(self):
        return len(self.base)

    def num_tokens(self, i: int) -> int:
        return self.base.num_tokens(i) + 1

    def __getitem__(self, i: int):
        item = dict(self.base[i])
        src = item["source"]
        if self.src_prepend is not None:
            src = np.concatenate([[self.src_prepend], src]).astype(src.dtype)
        if self.src_append is not None:
            src = np.concatenate([src, [self.src_append]]).astype(src.dtype)
        item["source"] = src
        if self.tgt_append is not None:
            tgt = item["target"]
            item["target"] = np.concatenate([tgt, [self.tgt_append]]).astype(tgt.dtype)
        if self.tgt_bos is not None:
            item["_tgt_bos"] = self.tgt_bos
        return item

    def collater(self, samples, **kwargs):
        tagged = bool(samples) and "_tgt_bos" in samples[0]
        if tagged:
            # the base collater's order, so that each row gets its own tag
            samples = sorted(samples, key=lambda s: -len(s["source"]))
        batch = self.base.collater(samples, **kwargs)
        if tagged:
            prev = batch["prev_output_tokens"].copy()
            prev[:, 0] = np.asarray([s["_tgt_bos"] for s in samples], prev.dtype)
            batch["prev_output_tokens"] = prev
        return batch


def smoothed_ratios(sizes, exponent: float) -> np.ndarray:
    """Each part's size ratio when the parts are drawn with probabilities
    (n_i / N)^exponent, renormalised, over the same total."""
    probs = np.asarray(sizes, np.float64) / max(sum(sizes), 1)
    smoothed = probs ** exponent
    smoothed /= smoothed.sum()
    return smoothed * sum(sizes) / np.maximum(sizes, 1)


@register_task("translation_multi_simple_epoch")
class TranslationMultiSimpleEpochTask(ChimeraTask):
    def __init__(self, cfg: Dict, dictionary: Dictionary, pairs: List[str]):
        super().__init__(cfg)
        self.dictionary = dictionary
        self.pairs = pairs
        for lang in sorted({l for p in pairs for l in p.split("-")}):
            dictionary.add_symbol(f"__{lang}__")

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        pairs = cfg.get("lang_pairs")
        if not pairs:
            raise ValueError("translation_multi_simple_epoch needs --lang-pairs")
        pairs = pairs.split(",") if isinstance(pairs, str) else list(pairs)
        dict_path = root / "dict.txt"  # one shared vocabulary
        if not dict_path.exists():
            dict_path = root / f"dict.{pairs[0].split('-')[0]}.txt"
        return cls(cfg, cls.load_dictionary(str(dict_path)), pairs)

    def lang_token(self, lang: str) -> int:
        return self.dictionary.index(f"__{lang}__")

    def lang_tag_indices(self):
        return {self.lang_token(l) for p in self.pairs for l in p.split("-")}

    def load_dataset(self, split: str, **kwargs):
        root = Path(self.cfg["data"])
        encoder_langtok = self.cfg.get("encoder_langtok", "tgt")  # src | tgt | None
        decoder_langtok = bool(self.cfg.get("decoder_langtok", False))
        parts, sizes = [], []
        for pair in self.pairs:
            src, tgt = pair.split("-")
            prefix = str(root / f"{split}.{src}-{tgt}.")
            base = LanguagePairDataset(MMapIndexedDataset(prefix + src),
                                       MMapIndexedDataset(prefix + tgt),
                                       self.dictionary, self.dictionary)
            prepend = {"tgt": tgt, "src": src}.get(encoder_langtok)
            parts.append(LangTokPairDataset(
                base, src_prepend=None if prepend is None else self.lang_token(prepend),
                tgt_bos=self.lang_token(tgt) if decoder_langtok else None))
            sizes.append(len(base))
        if split == self.cfg.get("train_subset", "train") and len(parts) > 1:
            if "sampling_temperature" in self.cfg:
                t = float(self.cfg.get("sampling_temperature") or 1.0)
                exponent = 1.0 / t if t > 0 else 1.0
            else:
                exponent = float(self.cfg.get("sampling_alpha", 1.0))
            parts = [ResamplingDataset(ds, size_ratio=float(r), seed=int(self.cfg.get("seed", 1)))
                     for ds, r in zip(parts, smoothed_ratios(sizes, exponent))]
        self.datasets[split] = IdStampedConcat(parts)

    @property
    def source_dictionary(self) -> Dictionary:
        return self.dictionary

    @property
    def target_dictionary(self) -> Dictionary:
        return self.dictionary

    def collate_indices(self, dataset, idx, target_len=None):
        return collate_pairs(dataset, idx)


@register_task("translation_from_pretrained_bart")
class TranslationFromPretrainedBARTTask(TranslationTask):
    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        task = super().setup_task(cfg, **kwargs)
        langs = cfg.get("langs") or f"{cfg['source_lang']},{cfg['target_lang']}"
        task.langs = [l for l in str(langs).split(",") if l]
        for d in (task.src_dict, task.tgt_dict):
            for l in task.langs:
                d.add_symbol(f"[{l}]")
            # the (m)BART vocabulary ends with <mask> after the language tags
            d.add_symbol("<mask>")
        return task

    def lang_tag_indices(self):
        return {d.index(f"[{l}]") for d in (self.src_dict, self.tgt_dict) for l in self.langs
                if f"[{l}]" in d.indices}

    def load_dataset(self, split: str, **kwargs):
        super().load_dataset(split, **kwargs)
        src, tgt = self.cfg["source_lang"], self.cfg["target_lang"]
        self.datasets[split] = LangTokPairDataset(
            self.datasets[split], src_append=self.src_dict.index(f"[{src}]"),
            tgt_bos=self.tgt_dict.index(f"[{tgt}]"),
            tgt_append=self.tgt_dict.index(f"[{tgt}]"))


@register_task("translation_from_pretrained_xlm")
class TranslationFromPretrainedXLMTask(TranslationTask):
    def model_config_overrides(self, cfg: Dict) -> Dict:
        out = super().model_config_overrides(cfg)
        out.setdefault("arch", "transformer_from_pretrained_xlm")
        return out

    def post_init_params(self, model, args=None) -> None:
        """The pretrained XLM weights over the fresh model's, in place (the
        train CLI calls this after the initialisation)."""
        ckpt = self.cfg.get("pretrained_xlm_checkpoint") or getattr(
            args, "pretrained_xlm_checkpoint", None)
        if not ckpt:
            return
        from ..checkpoint.store import read_state
        from ..convert import params_from_flax
        from ..models.roberta_hub import init_transformer_from_pretrained_xlm

        xlm_state = params_from_flax(read_state(str(ckpt))["params"], "masked_lm")
        merged = init_transformer_from_pretrained_xlm(
            model.state_dict(), xlm_state, init_decoder=bool(self.cfg.get("init_decoder", False)))
        model.load_state_dict(merged, strict=True)
        logger.info(f"initialized encoder from XLM checkpoint {ckpt}")


@register_task("semisupervised_translation")
class SemisupervisedTranslationTask(ChimeraTask):
    text_only = True

    def __init__(self, cfg: Dict, src_dict: Dictionary, tgt_dict: Dictionary):
        super().__init__(cfg)
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.backtranslate_fn: Optional[Callable] = None  # set by a trainer or a user

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        root = Path(cfg["data"])
        src, tgt = cfg.get("source_lang"), cfg.get("target_lang")
        if src is None or tgt is None:
            src, tgt = TranslationTask.infer_language_pair(root)
        cfg["source_lang"], cfg["target_lang"] = src, tgt
        return cls(cfg, cls.load_dictionary(str(root / f"dict.{src}.txt")),
                   cls.load_dictionary(str(root / f"dict.{tgt}.txt")))

    def load_dataset(self, split: str, **kwargs):
        from ..data.noising import NoisingDataset

        root = Path(self.cfg["data"])
        src, tgt = self.cfg["source_lang"], self.cfg["target_lang"]
        lam_par = float(self.cfg.get("lambda_parallel", 1.0))
        lam_dae = float(self.cfg.get("lambda_denoising", 0.0))
        prefix = str(root / f"{split}.{src}-{tgt}.")
        parallel = LanguagePairDataset(MMapIndexedDataset(prefix + src),
                                       MMapIndexedDataset(prefix + tgt),
                                       self.src_dict, self.tgt_dict)
        parts = [(parallel, lam_par)] if lam_par > 0 else []
        if lam_dae > 0 and split == self.cfg.get("train_subset", "train"):
            # noised(tgt) -> tgt over the target side's monolingual split
            mono_path = root / f"{split}.{tgt}"
            if Path(str(mono_path) + ".idx").exists():
                mono = MMapIndexedDataset(str(mono_path))
            else:
                mono = MMapIndexedDataset(prefix + tgt)
            noised = NoisingDataset(mono, self.tgt_dict, seed=int(self.cfg.get("seed", 1)),
                                    dropout_prob=float(self.cfg.get("word_dropout", 0.1)),
                                    max_shuffle_distance=int(self.cfg.get("word_shuffle", 3)))
            parts.append((_PairedView(noised, mono), lam_dae))
        if not parts:
            raise ValueError("all lambda weights are zero")
        total = sum(w for _, w in parts)
        datasets = []
        for ds, w in parts:
            ratio = w / total * len(parts)
            datasets.append(ResamplingDataset(ds, size_ratio=max(ratio, 0.01),
                                              seed=int(self.cfg.get("seed", 1)))
                            if ratio != 1.0 else ds)
        self.datasets[split] = _SemiConcat(datasets, parallel)

    @property
    def source_dictionary(self) -> Dictionary:
        return self.src_dict

    @property
    def target_dictionary(self) -> Dictionary:
        return self.tgt_dict

    def collate_indices(self, dataset, idx, target_len=None):
        return collate_pairs(dataset, idx)


class _PairedView:
    """(noised source, clean target) pairs of a monolingual dataset."""

    def __init__(self, noised, clean):
        self.noised = noised
        self.clean = clean

    def __len__(self):
        return len(self.clean)

    def num_tokens(self, i: int) -> int:
        sizes = getattr(self.clean, "sizes", None)
        if sizes is not None:
            return int(sizes[i])
        return len(self.clean[i])

    def __getitem__(self, i: int):
        return {"id": i, "source": np.asarray(self.noised[i], np.int32),
                "target": np.asarray(self.clean[i], np.int32)}


class _SemiConcat(IdStampedConcat):
    """The parts one after another, collated by the parallel dataset."""

    def __init__(self, parts, collate_owner: LanguagePairDataset):
        super().__init__(parts)
        self._owner = collate_owner

    def collater(self, samples, **kwargs):
        return self._owner.collater(samples, **kwargs)
