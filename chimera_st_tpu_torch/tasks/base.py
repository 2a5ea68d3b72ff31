"""Task base class (counterpart of chimera_st_tpu/tasks/base.py, the parts
inference and the training step read).

A task owns dictionaries, datasets, and the glue that builds models,
generators and batch iterators. ``make_batch_iterator`` keeps the JAX
package's batch order and padded lengths (descending stable sort by size,
``batch_by_size``, DP-optimal bucket edges, ``pad_to_bucket``): the padded
length of a batch changes the model's output, because the extractor's group
norm spans the whole padded time axis, so hypotheses identical to the JAX
CLI's need batches identical to it. A task with ``batch_groups`` (the
multilingual translation task: one group a language pair) has each group
packed on its own, so that no batch mixes groups and none is dropped.
"""

from __future__ import annotations

import functools
import inspect
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config.registry import ARCHITECTURES, CRITERIONS, MODELS
from ..data.batching import batch_by_size, optimal_buckets, pad_to_bucket
from ..data.dictionary import Dictionary
from ..data.iterators import EpochBatchIterator

logger = logging.getLogger(__name__)


class ChimeraTask:
    def __init__(self, cfg: Dict):
        self.cfg = cfg
        self.datasets: Dict[str, Any] = {}

    # ------------------------------------------------------------- factory

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs) -> "ChimeraTask":
        return cls(cfg)

    @classmethod
    def load_dictionary(cls, filename: str) -> Dictionary:
        return Dictionary.load(filename)

    # --------------------------------------------------------------- data

    def load_dataset(self, split: str, **kwargs):
        raise NotImplementedError

    def dataset(self, split: str):
        if split not in self.datasets:
            self.load_dataset(split)
        return self.datasets[split]

    # -------------------------------------------------------------- models

    def build_model(self, model_cfg: Dict, dtype=torch.float32, device="cuda",
                    train: bool = False):
        """The model of ``model_cfg["arch"]`` on ``device``. For inference
        it is in eval mode, its linear / conv / embedding parameters in
        ``dtype``; with ``train`` it is in train mode with fp32 parameters
        (Adam keeps fp32 masters; bf16 compute comes from ``torch.autocast``)."""
        from .. import models  # noqa: F401 — registration side effects
        from ..models.layers import cast_compute_dtype_

        if train and dtype != torch.float32:
            raise ValueError("a model built for training keeps fp32 parameters; "
                             "run bf16 compute under torch.autocast")

        arch = model_cfg.get("arch") or model_cfg.get("_name")
        full_cfg = self.model_config_overrides(dict(model_cfg))
        if arch in ARCHITECTURES or arch not in MODELS:
            # an unported or unknown arch raises from the architecture registry
            model_name, preset = ARCHITECTURES.get(arch)
            full_cfg = preset(full_cfg)
            build_fn = MODELS.get(model_name)
        else:
            build_fn = MODELS.get(arch)
        model = build_fn(full_cfg, device=device)
        if train:
            return model.train()
        return cast_compute_dtype_(model.eval(), dtype)

    def build_criterion(self, crit_cfg: Dict):
        """The registered criterion ``crit_cfg["_name"]`` (JAX
        ``tasks/base.py:98``); the target dictionary's pad index is its
        ignore index unless the config names one."""
        from .. import criterions  # noqa: F401 — registration side effects

        cfg = dict(crit_cfg)
        if self.target_dictionary is not None:
            cfg.setdefault("padding_idx", self.target_dictionary.pad())
        return CRITERIONS.get(cfg["_name"])(cfg)

    def model_config_overrides(self, cfg: Dict) -> Dict:
        """Inject task-derived fields (vocab sizes) into the model config."""
        if self.target_dictionary is not None:
            cfg.setdefault("tgt_vocab_size", len(self.target_dictionary))
        cfg.setdefault(
            "src_vocab_size",
            len(self.source_dictionary) if self.source_dictionary else None,
        )
        if cfg.get("character_embeddings") and self.target_dictionary is not None:
            # the character embedder's word -> byte spelling table, built
            # from the dictionary at every build (never saved)
            from ..models.character_embedder import build_word_to_char

            cfg.setdefault("word_to_char", build_word_to_char(
                self.target_dictionary, int(cfg.get("max_char_len", 50))))
        return cfg

    def build_generator(self, model, gen_cfg, strategy=None):
        from ..generation.generator import (
            SequenceGenerator,
            refuse_nat_settings,
            require_ported,
            settings_from_cfg,
        )

        require_ported(gen_cfg)  # a setting whose feature is not ported raises
        refuse_nat_settings(gen_cfg)
        d = self.target_dictionary
        return SequenceGenerator(model, settings_from_cfg(gen_cfg), pad=d.pad(), eos=d.eos(),
                                 unk=d.unk(), strategy=strategy)

    # ------------------------------------------------------------ batching

    def batch_groups(self, dataset) -> Optional[np.ndarray]:
        """Optional [len(dataset)] group ids: where given, every batch is
        packed from one group (JAX ``tasks/base.py:154``)."""
        return None

    def make_batch_iterator(
        self,
        dataset,
        max_tokens: Optional[int] = None,
        max_sentences: Optional[int] = None,
        required_batch_size_multiple: int = 1,
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
        num_length_buckets: int = 10,
        max_positions: Optional[int] = None,
        buffer_size: int = 4,
        num_workers: int = 1,
    ) -> EpochBatchIterator:
        """The JAX package's iterator over ``dataset``: batches by size over
        the descending stable sort, every batch padded to the smallest
        covering bucket edge, shuffled per epoch from ``seed`` and sharded
        by the iterator. A dataset that re-samples per epoch (``set_epoch``)
        is re-packed each epoch, its bucket edges those of epoch 1. With
        ``batch_groups`` each group is packed on its own, in group order."""
        if len(dataset) == 0:
            raise ValueError(
                "dataset is empty after size filtering — check "
                "min/max sample-size limits against the manifest"
            )

        def token_sizes():
            return np.asarray([dataset.num_tokens(int(i)) for i in range(len(dataset))])

        sizes = token_sizes()
        edges = optimal_buckets(sizes[sizes > 0] if (sizes > 0).any() else sizes,
                                num_length_buckets)

        def build_batches(epoch: int):
            epoch_sizes = sizes
            if hasattr(dataset, "set_epoch"):
                dataset.set_epoch(epoch)
                epoch_sizes = token_sizes()
            order = np.argsort(-epoch_sizes, kind="stable")
            if max_positions is not None:
                order = order[epoch_sizes[order] <= max_positions]
            groups = self.batch_groups(dataset)
            pack = functools.partial(batch_by_size, max_tokens=max_tokens,
                                     max_sentences=max_sentences,
                                     required_batch_size_multiple=required_batch_size_multiple)
            if groups is None:
                return pack(order, epoch_sizes)
            groups = np.asarray(groups)
            return [b for g in np.unique(groups[order])
                    for b in pack(order[groups[order] == g], epoch_sizes)]

        # a task whose noise re-rolls each epoch (translation_lev) takes the
        # epoch, as the JAX base task gives it
        takes_epoch = "epoch" in inspect.signature(self.collate_indices).parameters

        def collate(idx: np.ndarray, epoch: int = 1):
            batch_max = max(dataset.num_tokens(int(i)) for i in idx)
            extra = {"epoch": epoch} if takes_epoch else {}
            return self.collate_indices(dataset, idx, pad_to_bucket(batch_max, edges), **extra)

        return EpochBatchIterator(
            collate,
            build_batches if hasattr(dataset, "set_epoch") else build_batches(1),
            seed=seed,
            num_shards=num_shards,
            shard_id=shard_id,
            buffer_size=buffer_size,
            num_workers=num_workers,
        )

    def collate_indices(self, dataset, idx: np.ndarray, audio_target_len: int):
        samples = [dataset[int(i)] for i in idx]
        return dataset.collater(samples, audio_target_len)

    # --------------------------------------------------------------- dicts

    @property
    def source_dictionary(self) -> Optional[Dictionary]:
        return None

    @property
    def target_dictionary(self) -> Optional[Dictionary]:
        return None

    # ------------------------------------------------------------- decode

    def post_process_text(self, tokens: np.ndarray, bpe_symbol="sentencepiece") -> str:
        d = self.target_dictionary
        return d.string(tokens, bpe_symbol=bpe_symbol)
