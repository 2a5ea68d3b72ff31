"""Native checkpoint store (counterpart of chimera_st_tpu/checkpoint/store.py
and of the ``.ckpt`` branch of its ``cli/generate.py``
``load_model_and_params``).

A ``.ckpt`` is one pickle, the JAX trainer's layout: ``step``, ``params`` as
a flax variables dict (``{"params": …}``) of numpy arrays, ``opt_state`` as
optax's tree of numpy arrays (or None under ``--no-save-optimizer-state``),
``extra`` (the run's ``model_cfg`` / ``task_cfg`` / ``criterion_cfg``, the
iterator position, the best metric, the meters, the training time) and
``format_version`` 1. Either package reads the other's files; reading needs
numpy only, and the pickle names no class of either package. The trees are
carried across with ``convert``; a file is written to ``.tmp`` and then
moved into place. Naming and retention follow the JAX ``CheckpointManager``:
``checkpoint_last`` / ``checkpoint_best`` / ``checkpoint{epoch}`` /
``checkpoint_{epoch}_{updates}`` / ``checkpoint.best_{score}_{updates}``,
written once and replicated, then pruned. A replica is a hard link of the
written file where the file system allows one (the JAX manager copies: the
bytes are the same, and no file is ever changed in place), else a copy.
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

logger = logging.getLogger(__name__)

SUFFIX = ".ckpt"


class TrainState(NamedTuple):
    """A trainer's state as host trees, in the JAX package's layout."""

    step: int
    params: Dict[str, Any]
    opt_state: Optional[Dict[str, Any]]


def save_state(path: str, state: TrainState, extra: Dict[str, Any]) -> None:
    payload = {
        "step": int(state.step),
        "params": state.params,
        "opt_state": state.opt_state,
        "extra": extra,
        "format_version": 1,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    Path(tmp).replace(path)


def replicate_file(src: Path, dst: Path) -> None:
    """``dst`` with ``src``'s bytes: a hard link, or a copy where the file
    system refuses one; moved into place as a write is."""
    tmp = Path(str(dst) + ".tmp")
    tmp.unlink(missing_ok=True)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    tmp.replace(dst)


def save_model(path: str, model, model_cfg: Dict[str, Any], kind: Optional[str] = None) -> None:
    """A native checkpoint of ``model``'s parameters alone (no optimizer
    state) with ``model_cfg`` in ``extra``: what either package's generate
    CLI rebuilds the model from. ``kind`` names ``convert``'s table (by
    default ``convert.model_kind(model)``)."""
    from .. import convert

    kind = kind or convert.model_kind(model)
    save_state(path, TrainState(0, convert.params_to_flax(model.state_dict(), kind), None),
               {"model_cfg": dict(model_cfg)})


def read_state(path: str) -> Dict[str, Any]:
    """The payload of a native checkpoint."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "params" not in payload:
        raise ValueError(f"{path}: not a native checkpoint (no 'params' entry)")
    return payload


def load_native_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (flax parameter tree with numpy leaves, model_cfg dict)."""
    payload = read_state(path)
    model_cfg = dict((payload.get("extra") or {}).get("model_cfg") or {})
    return payload["params"], model_cfg


def load_params_only(path: str, trainer) -> None:
    """The parameters of the checkpoint at ``path`` into the trainer's
    model; its optimizer state and update count stay as they are."""
    trainer.load_params(read_state(path)["params"])


def load_state(payload: Dict[str, Any], trainer) -> Dict[str, Any]:
    """Restores parameters, optimizer state and update count into the
    trainer and returns ``extra``. When the checkpoint holds no optimizer
    state, or one of another layout (saved with ``--fix-*`` and restored
    without, or another optimizer chain), the trainer keeps a fresh
    optimizer state, with a warning, as the JAX ``load_state`` does."""
    trainer.load_params(payload["params"])
    try:
        if payload.get("opt_state") is None:
            raise KeyError("checkpoint saved with --no-save-optimizer-state")
        trainer.load_opt_state(payload["opt_state"])
    except (ValueError, KeyError) as e:
        logger.warning(f"optimizer state does not match the current optimizer ({e}); "
                       "keeping freshly initialized optimizer state")
    trainer.set_num_updates(int(payload["step"]))
    return payload.get("extra", {})


class CheckpointManager:
    """Naming, retention and best tracking, as the JAX package's.
    ``save`` takes ``state``, a function ``save_optimizer -> TrainState``,
    so that the host copies are made only when a file is written, once."""

    def __init__(
        self,
        save_dir: str,
        maximize_best: bool = False,
        keep_last_epochs: int = -1,
        keep_interval_updates: int = -1,
        keep_best_checkpoints: int = -1,
        no_last: bool = False,
        save_optimizer_state: bool = True,
        no_epoch: bool = False,
        no_save: bool = False,
    ):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.maximize_best = maximize_best
        self.keep_last_epochs = keep_last_epochs
        self.keep_interval_updates = keep_interval_updates
        self.keep_best_checkpoints = keep_best_checkpoints
        self.no_last = no_last
        self.no_epoch = no_epoch
        self.no_save = no_save
        self.save_optimizer_state = save_optimizer_state
        self.best: Optional[float] = None
        self.verify_writable()

    def verify_writable(self):
        probe = self.save_dir / "dummy"
        try:
            with open(probe, "w") as f:
                f.write("ok")
        finally:
            probe.unlink(missing_ok=True)

    def is_better(self, val: float) -> bool:
        if self.best is None:
            return True
        return val > self.best if self.maximize_best else val < self.best

    def save(
        self,
        state: Callable[[bool], TrainState],
        extra: Dict[str, Any],
        epoch: int,
        updates: int,
        val_metric: Optional[float] = None,
        end_of_epoch: bool = True,
        save_interval_updates: int = 0,
    ):
        # best is tracked before any early return: patience reads
        # is_better() / best, which must advance under --no-save too
        is_best = val_metric is not None and self.is_better(val_metric)
        if is_best:
            self.best = val_metric
        if self.no_save:
            return
        extra = dict(extra)
        extra["best"] = self.best
        wrote = []
        t0 = time.time()
        host: Optional[TrainState] = None

        def _save(name):
            nonlocal host
            if host is None:
                host = state(self.save_optimizer_state)
            save_state(str(self.save_dir / name), host, extra)
            wrote.append(name)

        # write once, then replicate
        primary = None
        if end_of_epoch and not self.no_epoch:
            primary = f"checkpoint{epoch}{SUFFIX}"
            _save(primary)
        elif not end_of_epoch and save_interval_updates > 0:
            primary = f"checkpoint_{epoch}_{updates}{SUFFIX}"
            _save(primary)

        def _replicate(name):
            nonlocal primary
            if primary is not None:
                replicate_file(self.save_dir / primary, self.save_dir / name)
            else:  # the first file written is the one the others replicate
                _save(name)
                primary = name
            if name not in wrote:
                wrote.append(name)

        if is_best:
            _replicate(f"checkpoint_best{SUFFIX}")
        if self.keep_best_checkpoints > 0 and val_metric is not None:
            _replicate(f"checkpoint.best_{val_metric:.4f}_{updates}{SUFFIX}")
        if not self.no_last:
            _replicate(f"checkpoint_last{SUFFIX}")

        self._prune()
        logger.info(
            f"saved checkpoint(s) {wrote} (epoch {epoch}, {updates} updates, "
            f"{time.time() - t0:.1f}s)"
        )

    def _prune(self):
        if self.keep_last_epochs > 0:
            ckpts = sorted(
                self.save_dir.glob(f"checkpoint[0-9]*{SUFFIX}"),
                key=lambda p: int(re.match(r"checkpoint(\d+)", p.stem).group(1)),
            )
            for p in ckpts[: -self.keep_last_epochs]:
                p.unlink(missing_ok=True)
        if self.keep_best_checkpoints > 0:
            def score_of(p):  # checkpoint.best_<score>_<updates>.ckpt
                return float(p.stem.split("_")[-2])

            ckpts = sorted(
                self.save_dir.glob(f"checkpoint.best_*{SUFFIX}"),
                key=score_of,
                reverse=not self.maximize_best,  # worst first
            )
            if len(ckpts) > self.keep_best_checkpoints:
                for p in ckpts[: -self.keep_best_checkpoints]:
                    p.unlink(missing_ok=True)
        if self.keep_interval_updates > 0:
            ckpts = sorted(
                self.save_dir.glob(f"checkpoint_*_*{SUFFIX}"),
                key=lambda p: int(p.stem.split("_")[-1]),
            )
            for p in ckpts[: -self.keep_interval_updates]:
                p.unlink(missing_ok=True)


def prune_layer_params(state: Dict[str, Any], layers_to_keep, prefix: str = "layers."
                       ) -> Dict[str, Any]:
    """Load a deep checkpoint into a shallower model: of the names
    ``{prefix}{i}.…`` of a state dict (``prefix`` e.g. ``"decoder.layers."``)
    keep the listed layer indices (a list, or a comma-joined string) and
    renumber them consecutively; other names pass through. The counterpart
    of the JAX package's pruning of a ``layers_{i}`` subtree (``convert``
    names both alike)."""
    if isinstance(layers_to_keep, str):
        layers_to_keep = [int(x) for x in layers_to_keep.split(",") if x != ""]
    keep = sorted(int(i) for i in layers_to_keep)
    stack = re.compile(re.escape(prefix) + r"(\d+)\.(.+)")
    layers: Dict[int, Dict[str, Any]] = {}
    out: Dict[str, Any] = {}
    for k, v in state.items():
        m = stack.fullmatch(k)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = v
        else:
            out[k] = v
    for new_i, old_i in enumerate(keep):
        if old_i not in layers:
            raise KeyError(f"layer {prefix}{old_i} not present (prune list {keep})")
        for rest, v in layers[old_i].items():
            out[f"{prefix}{new_i}.{rest}"] = v
    return out
