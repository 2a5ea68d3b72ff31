"""Typed configuration tree (counterpart of
chimera_st_tpu/config/configs.py; fairseq ``dataclass/configs.py``): the
reference's top-level groups (common / distributed / dataset / optimization
/ checkpoint / generation) as plain dataclasses with a dict and YAML round
trip, no omegaconf. Component nodes (task / model / criterion / optimizer /
lr_scheduler / bpe / tokenizer / scoring) are free-form dicts keyed by
``_name``, resolved through :mod:`chimera_st_tpu_torch.config.registry`.
The fields and their defaults are the JAX package's, so a YAML written by
either package reads back in the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _asdict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _asdict(v) for k, v in obj.items()}
    return obj


class _Base:
    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        import typing

        hints = typing.get_type_hints(cls)
        known = {f.name for f in fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in known:
                continue
            t = hints.get(k)
            if (
                t is not None
                and isinstance(t, type)
                and dataclasses.is_dataclass(t)
                and isinstance(v, dict)
            ):
                v = t.from_dict(v)
            kwargs[k] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class CommonConfig(_Base):
    seed: int = 1
    log_interval: int = 100
    log_format: Optional[str] = None
    tensorboard_logdir: Optional[str] = None
    # bf16 compute over fp32 parameters (no fp16 loss scaling)
    dtype: str = "bfloat16"  # compute dtype: float32 | bfloat16
    param_dtype: str = "float32"
    profile: bool = False
    user_dir: Optional[str] = None
    empty_cache_freq: int = 0
    all_gather_list_size: int = 16384


@dataclass
class DistributedConfig(_Base):
    # the JAX package's mesh description; the port's rank grid over
    # torch.distributed is parallel/mesh.py (one process a card)
    data_parallel: int = -1  # -1: infer = n_devices / (model*pipeline)
    model_parallel: int = 1
    pipeline_parallel: int = 1
    # multi-host initialization; None = single-host
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # ZeRO-1: shard optimizer state over the data axis
    zero_sharding: str = "none"  # none | os


@dataclass
class DatasetConfig(_Base):
    num_workers: int = 2
    max_tokens: Optional[int] = None
    batch_size: Optional[int] = None
    required_batch_size_multiple: int = 8
    train_subset: str = "train"
    valid_subset: str = "valid"
    validate_interval: int = 1
    validate_interval_updates: int = 0
    fixed_validation_seed: Optional[int] = None
    disable_validation: bool = False
    max_tokens_valid: Optional[int] = None
    batch_size_valid: Optional[int] = None
    curriculum: int = 0
    gen_subset: str = "test"
    num_shards: int = 1
    shard_id: int = 0
    data_buffer_size: int = 10
    skip_invalid_size_inputs_valid_test: bool = False
    # each batch padded up to a bucket boundary (the JAX package's batches)
    num_length_buckets: int = 10


@dataclass
class OptimizationConfig(_Base):
    max_epoch: int = 0
    max_update: int = 0
    stop_time_hours: float = 0.0
    clip_norm: float = 0.0
    update_freq: List[int] = field(default_factory=lambda: [1])
    lr: List[float] = field(default_factory=lambda: [0.25])
    stop_min_lr: float = -1.0
    sentence_avg: bool = False
    skip_remainder_batch: bool = False


@dataclass
class CheckpointConfig(_Base):
    save_dir: str = "checkpoints"
    restore_file: str = "checkpoint_last"
    finetune_from_model: Optional[str] = None
    reset_dataloader: bool = False
    reset_lr_scheduler: bool = False
    reset_meters: bool = False
    reset_optimizer: bool = False
    optimizer_overrides: str = "{}"
    save_interval: int = 1
    save_interval_updates: int = 0
    keep_interval_updates: int = -1
    keep_last_epochs: int = -1
    keep_best_checkpoints: int = -1
    no_save: bool = False
    no_epoch_checkpoints: bool = False
    no_last_checkpoints: bool = False
    no_save_optimizer_state: bool = False
    best_checkpoint_metric: str = "loss"
    maximize_best_checkpoint_metric: bool = False
    patience: int = -1
    checkpoint_suffix: str = ""


@dataclass
class GenerationConfig(_Base):
    beam: int = 5
    nbest: int = 1
    max_len_a: float = 0.0
    max_len_b: int = 200
    min_len: int = 1
    match_source_len: bool = False
    unnormalized: bool = False
    no_early_stop: bool = False
    unkpen: float = 0.0
    lenpen: float = 1.0
    prefix_size: int = 0
    no_repeat_ngram_size: int = 0
    sampling: bool = False
    sampling_topk: int = -1
    sampling_topp: float = -1.0
    temperature: float = 1.0
    diverse_beam_groups: int = -1
    diverse_beam_strength: float = 0.5
    diversity_rate: float = -1.0
    print_alignment: bool = False
    replace_unk: Optional[str] = None
    score_reference: bool = False
    remove_bpe: Optional[str] = None
    quiet: bool = False
    results_path: Optional[str] = None
    scoring: str = "sacrebleu"
    controlled_generator: bool = False
    # static decode-loop bound; actual stop uses max_len_a/b per sentence
    max_decode_len: int = 512


@dataclass
class ChimeraConfig(_Base):
    """Root config. Component nodes are `_name`-keyed dicts."""

    common: CommonConfig = field(default_factory=CommonConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)

    task: Dict[str, Any] = field(default_factory=dict)
    model: Dict[str, Any] = field(default_factory=dict)
    criterion: Dict[str, Any] = field(default_factory=lambda: {"_name": "cross_entropy"})
    optimizer: Dict[str, Any] = field(default_factory=lambda: {"_name": "adam"})
    lr_scheduler: Dict[str, Any] = field(default_factory=lambda: {"_name": "fixed"})
    bpe: Dict[str, Any] = field(default_factory=dict)
    tokenizer: Dict[str, Any] = field(default_factory=dict)
    scoring: Dict[str, Any] = field(default_factory=lambda: {"_name": "sacrebleu"})

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @classmethod
    def from_yaml(cls, text: str) -> "ChimeraConfig":
        import yaml

        return cls.from_dict(yaml.safe_load(text) or {})
