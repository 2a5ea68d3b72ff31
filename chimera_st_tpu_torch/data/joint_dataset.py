"""Joint multi-task batch scheduling (counterpart of
chimera_st_tpu/data/joint_dataset.py; reference fairseq/data/joint_dataset.py).

Each sub-task keeps its own dataset, batches and collater; the joint
iterator interleaves the per-task batch streams by sample ratio and tags
each batch with its ``task_name``. The schedule of an epoch is drawn from
``numpy.random.default_rng([seed, epoch])``, as in the JAX package, so both
give the same batches in the same order."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class JointBatchSchedule:
    def __init__(self, per_task_batches: Dict[str, List[np.ndarray]],
                 sample_ratios: Optional[Dict[str, float]] = None, seed: int = 1):
        self.per_task = per_task_batches
        self.ratios = sample_ratios or {k: 1.0 for k in per_task_batches}
        self.seed = seed

    def epoch_schedule(self, epoch: int) -> List[tuple]:
        """The epoch's interleave: [(task_name, batch_index), ...]. A task
        of n batches at ratio r contributes floor(n r) of them, one more
        with probability frac(n r), drawn from its batches repeated
        ceil(r) times."""
        rng = np.random.default_rng([self.seed, epoch])
        entries: List[tuple] = []
        for name, batches in self.per_task.items():
            ratio = self.ratios.get(name, 1.0)
            n = len(batches)
            reps = int(np.floor(n * ratio))
            frac = n * ratio - reps
            idx = list(range(n)) * int(np.ceil(ratio))
            take = reps + (1 if rng.random() < frac else 0)
            picked = rng.permutation(len(idx))[:take]
            entries.extend((name, idx[i]) for i in picked)
        order = rng.permutation(len(entries))
        return [entries[i] for i in order]
