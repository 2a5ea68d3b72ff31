"""Joint multi-task training (counterpart of chimera_st_tpu/tasks/joint_task.py;
reference fairseq/tasks/joint_task.py, joint_mtst.py): Chimera's joint
MT + ST fine-tune, one interlingua model trained on ST triplets and MT
pairs interleaved by sample ratio.

- ``joint_task``: N sub-tasks over one model, each with a ``weight``, a
  ``sample_ratio`` and its own criterion, given as dicts or as JSON / YAML
  files (``--task-configs st.json mt.json``; YAML needs the ``yaml``
  package, imported only for a ``.yaml`` file). ``main_task`` (by default
  the first) builds the model, gives the dictionaries and is validated.
- ``joint_task_mtst``: the same, and the sub-tasks' target dictionaries
  must be equal (one decoder serves them all).

Batches carry ``task_name``; the criterion dispatches on it and multiplies
the sub-criterion's loss by the sub-task's weight (its logging is the
sub-criterion's, unweighted). One update may hold micro-batches of several
sub-tasks: their gradients and sample sizes add, and the logged keys are
the union of theirs, as in the JAX trainer.

The reference's ``joint_model`` / ``joint_criterion`` names raise
``SystemExit`` with the JAX package's migration message.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np

from ..config.registry import (
    CRITERIONS,
    register_criterion,
    register_model,
    register_model_architecture,
    register_task,
)
from ..data.joint_dataset import JointBatchSchedule
from .base import ChimeraTask

logger = logging.getLogger(__name__)


def _load_task_config(entry) -> Dict:
    """A sub-task's config: a dict, or a JSON / YAML file."""
    if isinstance(entry, dict):
        return entry
    path = str(entry)
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            return yaml.safe_load(f)
        import json

        return json.load(f)


@register_task("joint_task")
class JointTrainingTask(ChimeraTask):
    """N sub-tasks over one shared model."""

    def __init__(self, cfg: Dict, sub_tasks: Dict[str, ChimeraTask],
                 weights: Dict[str, float], ratios: Dict[str, float]):
        super().__init__(cfg)
        self.sub_tasks = sub_tasks
        self.weights = weights
        self.ratios = ratios
        self.main_task_name = cfg.get("main_task") or next(iter(sub_tasks))

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        from . import setup_task as setup_sub

        cfg = dict(cfg)
        cfg["task_configs"] = [_load_task_config(tc) for tc in cfg["task_configs"]]
        sub_tasks, weights, ratios = {}, {}, {}
        for task_cfg in cfg["task_configs"]:
            name = task_cfg["task_name"]
            weights[name] = float(task_cfg.get("weight", 1.0))
            ratios[name] = float(task_cfg.get("sample_ratio", 1.0))
            sub_tasks[name] = setup_sub(dict(task_cfg["task"]))
        logger.info(f"joint task with sub-tasks: {list(sub_tasks)}")
        return cls(cfg, sub_tasks, weights, ratios)

    @property
    def main_task(self) -> ChimeraTask:
        return self.sub_tasks[self.main_task_name]

    @property
    def source_dictionary(self):
        return self.main_task.source_dictionary

    @property
    def target_dictionary(self):
        return self.main_task.target_dictionary

    def load_dataset(self, split: str, **kwargs):
        for t in self.sub_tasks.values():
            t.load_dataset(split)
        self.datasets[split] = {n: t.dataset(split) for n, t in self.sub_tasks.items()}

    def build_model(self, model_cfg: Dict, **kw):
        """One model, built against the main task's dictionaries."""
        return self.main_task.build_model(model_cfg, **kw)

    def build_criterion(self, crit_cfg: Dict) -> Callable:
        """A criterion that dispatches on ``batch["task_name"]`` to the
        sub-task's own (its ``criterion`` config, else ``crit_cfg``) and
        weights its loss."""
        from .. import criterions  # noqa: F401 — registration side effects

        per_task: Dict[str, Callable] = {}
        for task_cfg in self.cfg["task_configs"]:
            name = task_cfg["task_name"]
            sub_cfg = dict(task_cfg.get("criterion", crit_cfg))
            if self.sub_tasks[name].target_dictionary is not None:
                sub_cfg.setdefault("padding_idx", self.sub_tasks[name].target_dictionary.pad())
            per_task[name] = CRITERIONS.get(sub_cfg["_name"])(sub_cfg)
        weights = self.weights

        def criterion(model, batch, generator=None, num_updates=None):
            name = batch["task_name"]
            sub_batch = {k: v for k, v in batch.items() if k != "task_name"}
            loss, sample_size, logging = per_task[name](model, sub_batch, generator, num_updates)
            return weights.get(name, 1.0) * loss, sample_size, logging

        criterion.per_task = per_task
        return criterion

    def make_joint_iterator(self, split: str, max_tokens: Optional[int] = None,
                            max_sentences: Optional[int] = None, seed: int = 1,
                            num_length_buckets: int = 10, epoch: int = 1):
        """Yields the epoch's task-tagged batches, interleaved by sample
        ratio: each sub-task's batches by size over its descending stable
        sort, padded to its own bucket edges, collated by its task."""
        from ..data.batching import batch_by_size, optimal_buckets, pad_to_bucket

        per_task_batches, collate_fns = {}, {}
        for name, t in self.sub_tasks.items():
            ds = t.dataset(split)
            sizes = np.asarray([ds.num_tokens(i) for i in range(len(ds))])
            order = np.argsort(-sizes, kind="stable")
            per_task_batches[name] = batch_by_size(order, sizes, max_tokens=max_tokens,
                                                   max_sentences=max_sentences)
            edges = optimal_buckets(sizes, num_length_buckets)

            def collate(idx, t=t, ds=ds, sizes=sizes, edges=edges):
                return t.collate_indices(ds, idx, pad_to_bucket(int(sizes[idx].max()), edges))

            collate_fns[name] = collate

        schedule = JointBatchSchedule(per_task_batches, self.ratios, seed=seed)

        def gen():
            for name, bi in schedule.epoch_schedule(epoch):
                batch = collate_fns[name](per_task_batches[name][bi])
                batch["task_name"] = name
                yield batch

        return gen()


@register_task("joint_task_mtst")
class JointTrainingMTSTTask(JointTrainingTask):
    """Chimera's MT + ST joint fine-tune: both sub-tasks drive one
    interlingua model (its text branch the MT model, its audio branch the ST
    model), so their target dictionaries must be equal."""

    @classmethod
    def setup_task(cls, cfg: Dict, **kwargs):
        task = super().setup_task(cfg, **kwargs)
        dicts = [t.target_dictionary for t in task.sub_tasks.values()
                 if t.target_dictionary is not None]
        assert all(d == dicts[0] for d in dicts), (
            "joint_task_mtst shares the decoder across sub-tasks and requires "
            "a joint target vocabulary (the Chimera recipes use a joint SPM)"
        )
        return task


# the reference's joint_model / joint_criterion names: the joint task owns
# the shared model and dispatches the criterions itself
_JOINT_MIGRATION = (
    "the reference's {kind} `{name}` is superseded here: `--task joint_task` "
    "(or joint_task_mtst) owns the shared parameter tree and dispatches the "
    "per-sub-task criterions itself — configure the sub-task's own model/"
    "criterion names in the task-config JSON instead "
    "(see tasks/joint_task.py; reference models/joint_model.py:20, "
    "criterions/joint_criterion.py:13)"
)


@register_model("joint_model")
def _joint_model_shim(cfg_dict, device=None):
    raise SystemExit(_JOINT_MIGRATION.format(kind="model", name="joint_model"))


@register_model_architecture("joint_model", "joint_model")
def _joint_model_arch_shim(cfg):
    return dict(cfg)


@register_criterion("joint_criterion")
def _joint_criterion_shim(cfg):
    raise SystemExit(_JOINT_MIGRATION.format(kind="criterion", name="joint_criterion"))
