"""``translation_lev`` and ``translation_ins``: translation for the
non-autoregressive models (counterpart of
chimera_st_tpu/tasks/translation_lev.py; fairseq ``translation_lev``).

The text loads as ``translation`` loads it; ``build_generator`` hands a
NAT model to ``generation/nat_generator.py`` (any other model to the
beam search). In training each batch gets host-built targets by
``--noise``:

- ``levenshtein`` (default): ``ins_input`` (the target with a random share
  of its interior deleted), ``ins_targets`` (tokens to insert between
  adjacent inputs, clipped to the head's arity), ``masked_tgt`` (the target
  with its insertions as unk), ``del_input`` (the target with random tokens
  inserted) and ``del_targets``, from the edit operations of
  ``data/edit_ops.py``;
- ``random_mask`` (CMLM): ``masked_target`` with n ~ U(1, len) positions
  masked (eos kept) and ``target_lengths``;
- ``full_mask`` (vanilla / iterative NAT, NAT-CRF): every position but pad
  and eos masked.

Noise is drawn from one ``numpy.random.default_rng((seed, epoch, sample
id))`` a sample, as in JAX: a batch equals the JAX package's array for
array, and a mid-epoch resume replays the same noise. ``translation_ins``
adds the insertion transformer's per-slot tokens and weights; its collate
takes no epoch, in JAX as here, so its noise is that of epoch 1 in every
epoch (ROADMAP C).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config.registry import register_task
from ..criterions.nat_loss import cmlm_mask_target
from ..data.batching import collate_tokens, round16
from ..data.edit_ops import suggested_edit_ops
from .translation import TranslationTask

NOISES = ("levenshtein", "random_mask", "full_mask")


@register_task("translation_lev")
class TranslationLevenshteinTask(TranslationTask):
    BOS = 0
    UNK = 3

    def __init__(self, cfg, src_dict, tgt_dict):
        super().__init__(cfg, src_dict, tgt_dict)
        self.seed = int(cfg.get("seed", 1))
        self.delete_prob_max = float(cfg.get("random_delete_max", 0.5))
        self.insert_frac_max = float(cfg.get("random_insert_max", 0.3))
        self.max_ins = int(cfg.get("max_ins", 64))
        self.noise = str(cfg.get("noise", "levenshtein"))
        if self.noise not in NOISES:
            raise ValueError(f"unknown --noise {self.noise!r}")

    def _frame(self, target: np.ndarray) -> np.ndarray:
        """[tokens..., eos] -> [bos, tokens..., eos]."""
        return np.concatenate([[self.BOS], target]).astype(np.int32)

    def _random_delete(self, y: np.ndarray, rng) -> np.ndarray:
        """Drops a random share of the interior tokens."""
        n = len(y)
        if n <= 2:
            return y.copy()
        p = rng.uniform(0.0, self.delete_prob_max)
        keep = rng.random(n - 2) >= p
        return np.concatenate([y[:1], y[1:-1][keep], y[-1:]]).astype(np.int32)

    def _random_insert(self, y: np.ndarray, vocab: int, rng) -> np.ndarray:
        """Inserts k random non-special tokens before random positions."""
        n = len(y)
        k = int(rng.integers(0, max(int(self.insert_frac_max * n), 1) + 1))
        if k == 0:
            return y.copy()
        noise = rng.integers(4, max(vocab, 5), size=k).astype(np.int32)
        slots = rng.integers(1, n, size=k)  # insert before y[slot]
        out = list(y)
        for off, j in enumerate(np.argsort(slots, kind="stable")):
            out.insert(int(slots[j]) + off, int(noise[j]))
        return np.asarray(out, np.int32)

    def collate_indices(self, dataset, idx, target_len: Optional[int] = None, epoch: int = 1):
        batch = super().collate_indices(dataset, idx, target_len)
        if not batch or "target" not in batch:
            return batch
        pad = self.tgt_dict.pad()
        tgts = np.asarray(batch["target"])
        ids = np.asarray(batch["id"]) if "id" in batch else np.arange(len(tgts))
        rngs = [np.random.default_rng((self.seed, int(epoch), int(i))) for i in ids]

        if self.noise in ("random_mask", "full_mask"):
            eos = self.tgt_dict.eos()
            if self.noise == "random_mask":
                masked = np.stack([cmlm_mask_target(t, self.UNK, pad_idx=pad, rng=r)
                                   for t, r in zip(tgts, rngs)])
                masked = np.where(tgts == eos, tgts, masked)  # eos stays visible
            else:
                masked = np.where((tgts == pad) | (tgts == eos), tgts,
                                  np.full_like(tgts, self.UNK))
            batch["masked_target"] = masked.astype(np.int32)
            batch["target_lengths"] = (tgts != pad).sum(axis=1).astype(np.int32)
            return batch

        ys = [self._frame(t[t != pad]) for t in tgts]
        y_dels = [self._random_delete(y, r) for y, r in zip(ys, rngs)]
        y_inss = [self._random_insert(y, len(self.tgt_dict), r) for y, r in zip(ys, rngs)]
        y_pad, ydel_pad, yins_pad = (
            collate_tokens(rows, pad, target_len=round16(max(len(y) for y in rows)),
                           dtype=np.int32) for rows in (ys, y_dels, y_inss))
        ins_counts, ins_masks, _ = suggested_edit_ops(ydel_pad, y_pad, pad)
        _, _, del_labels = suggested_edit_ops(yins_pad, y_pad, pad)
        batch["lev_target"] = y_pad
        batch["ins_input"] = ydel_pad
        batch["ins_targets"] = np.clip(ins_counts, 0, self.max_ins - 1)
        batch["masked_tgt"] = np.where(ins_masks, self.UNK, y_pad).astype(np.int32)
        batch["del_input"] = yins_pad
        batch["del_targets"] = del_labels.astype(np.int32)
        return batch

    def build_generator(self, model, gen_cfg, strategy=None, reranker=None):
        from ..generation.nat_generator import build_nat_generator

        generator = build_nat_generator(model, gen_cfg, self.tgt_dict, bos=self.BOS,
                                        unk=self.UNK, reranker=reranker)
        if generator is None:  # an autoregressive model: the beam search
            return super().build_generator(model, gen_cfg, strategy)
        return generator


@register_task("translation_ins")
class TranslationInsertionTask(TranslationLevenshteinTask):
    """Adds the insertion transformer's per-slot (token, weight) targets."""

    def __init__(self, cfg, src_dict, tgt_dict):
        super().__init__(cfg, src_dict, tgt_dict)
        self.max_span = int(cfg.get("insertion_max_span", 8))
        self.tau = float(cfg.get("insertion_tau", 1.0))

    def collate_indices(self, dataset, idx, target_len=None):
        from ..models.nat_insertion import insertion_slot_targets

        batch = super().collate_indices(dataset, idx, target_len)
        if not batch or "ins_input" not in batch:
            return batch
        # the parent clipped ins_targets to its arity: recomputed unclipped
        ic, im, _ = suggested_edit_ops(batch["ins_input"], batch["lev_target"],
                                       self.tgt_dict.pad())
        batch["slot_tokens"], batch["slot_weights"] = insertion_slot_targets(
            batch["ins_input"], batch["lev_target"], ic, im, pad=self.tgt_dict.pad(),
            max_span=self.max_span, tau=self.tau)
        return batch
