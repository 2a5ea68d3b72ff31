"""One update of the fine-tune (counterpart of chimera_st_tpu/train/
train_step.py): the same semantics, run eagerly.

- ``prepare_batch``: a collated batch onto the device; int16 wire audio to
  float / 32768, the padding mask rebuilt from ``audio_lengths``.
- ``microbatch_grad``: the criterion on one micro-batch and its backward;
  ``.grad`` sums over micro-batches as the JAX accumulation does.
- ``apply_gradients``: divide by the total sample size, the fp32 global
  norm (reported before any clipping), then the optimizer at the schedule's
  lr; a non-finite norm leaves parameters, optimizer state and the update
  count unchanged. The skip is decided on the device (the fused Adam's
  ``found_inf``), so an update needs no host sync.
- ``TrainStep``: the accumulated update, bf16 compute under
  ``torch.autocast`` over fp32 parameters, dropout masks from a
  ``torch.Generator`` on the model's device, seeded afresh for each
  micro-batch from the update's seed (``microbatch_seed``), so a resumed
  run draws the masks an uninterrupted one draws. ``dispatch`` queues an
  update and returns its results on the device; ``collect`` reads them (the
  host's one sync) and takes back the host's count of a skipped update;
  calling the step does both. The exact count lives on the device
  (``count``, raised only by a finite update): the learning rate and the
  criterion's update count are taken from it, as the JAX step takes them
  from its optimizer's count, so they need no host read.
- ``valid_step``: the criterion in eval mode without gradients.

A joint task's micro-batch carries its ``task_name``, which reaches the
criterion with the batch (its dispatch); one update may mix sub-tasks,
whose sample sizes add and whose logged keys are the union of theirs.

Over several ranks (``mesh``, parallel/mesh.py) every rank is given the
same global micro-batches and takes its data rank's part
(``parallel.partition.shard_batch``); the summed gradients are all-reduced
over the ``data`` ranks in buckets while the last backward runs
(``parallel.reducer.GradientReducer``), and the sample sizes and logged
sums in one all-reduce on the device, so the update is normalised by the
global sample size and logs the global batch's values, as the JAX
package's one SPMD program does, with no host read before ``collect``.
The global norm counts a tensor-parallel shard's share once from each
``model`` rank.

The learning rate of an update is the schedule at the number of updates
applied before it (optax evaluates it at its count before incrementing),
in fp32 as optax's schedule gives it.
A parameter the loss does not reach gets a zero gradient, as every leaf of
a JAX gradient tree has one, so Adam decays its moments as optax does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..optim.optimizers import Optimizer

_TOKEN_KEYS = ("prev_output_tokens", "target", "src_text", "src_tokens", "net_tokens", "id",
               # the non-autoregressive models' canvases and labels
               "masked_target", "target_lengths", "lev_target", "ins_input", "ins_targets",
               "masked_tgt", "del_input", "del_targets", "slot_tokens",
               # sentence ranking's candidates
               "candidate_tokens")


def prepare_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Arrays of a collated batch -> tensors on ``device`` (token ids as
    int64); other entries (``ntokens``, ``nsentences``, a joint task's
    ``task_name``) pass through. A copy to the card goes from pinned memory
    without waiting for the card's queue."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if isinstance(value, torch.Tensor):
            if device.type == "cuda" and value.device.type == "cpu":
                value = value.pin_memory().to(device, non_blocking=True)
            else:
                value = value.to(device)
            if key in _TOKEN_KEYS:
                value = value.long()
        out[key] = value
    audio = out.get("audio")
    if audio is not None and audio.dtype == torch.int16:
        out["audio"] = audio.float() / 32768.0
    if audio is not None and out.get("audio_padding_mask") is None \
            and out.get("audio_lengths") is not None:
        pos = torch.arange(audio.shape[1], device=audio.device)[None, :]
        out["audio_padding_mask"] = pos >= out["audio_lengths"][:, None]
    return out


def microbatch_grad(model, criterion: Callable, batch: Dict[str, Any],
                    generator: Optional[torch.Generator] = None,
                    num_updates: Optional[int] = None,
                    weight: float = 1.0) -> Tuple[float, Dict[str, Any]]:
    """The criterion's loss on one prepared micro-batch, back-propagated
    into the parameters' ``.grad`` -> (sample size, logging); ``weight``
    scales all three (a batch that every data rank keeps whole)."""
    loss, sample_size, logging = criterion(model, batch, generator, num_updates)
    if weight != 1.0:
        loss = loss * weight
        sample_size = sample_size * weight
        logging = {k: v * weight if isinstance(v, (int, float, torch.Tensor))
                   and not isinstance(v, bool) else v for k, v in logging.items()}
    loss.backward()
    return sample_size, {k: v.detach() if torch.is_tensor(v) else v for k, v in logging.items()}


def microbatch_seed(seed: int, i: int) -> int:
    """The generator's seed for micro-batch ``i`` of the update whose seed
    is ``seed``: the first 64-bit word of ``numpy.random.SeedSequence((seed,
    i))``. The JAX trainer keys micro-batch i with ``fold_in(PRNGKey(seed),
    i)``; the masks differ from JAX's, the keying is the same."""
    return int(np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0])


def tensor_norms(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The fp32 L2 norm of each tensor, stacked."""
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.linalg.vector_norm(tensor_norms(tensors))


def apply_gradients(params: Sequence[torch.nn.Parameter], optimizer: Optimizer,
                    lr: torch.Tensor, sample_size: Union[float, torch.Tensor],
                    sharded: Optional[torch.Tensor] = None,
                    model_group=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalise the summed gradients by the total sample size, take their
    global norm and one optimizer update at ``lr``, which the optimizer
    skips on the device where the norm is not finite -> (the global norm,
    whether it is finite, each gradient's norm), on the device. ``sharded``
    marks the tensor-parallel shards, whose squared norms are summed over
    ``model_group``."""
    grads = [p.grad for p in params]
    denom = (sample_size.clamp(min=1.0) if torch.is_tensor(sample_size)
             else max(float(sample_size), 1.0))
    for g in grads:
        g.div_(denom)
    norms = tensor_norms(grads)
    if sharded is not None and model_group is not None:
        import torch.distributed as dist

        sq = torch.where(sharded, norms.square(), torch.zeros_like(norms))
        dist.all_reduce(sq, group=model_group)
        norms = torch.where(sharded, sq.sqrt(), norms)
    g_norm = torch.linalg.vector_norm(norms)
    finite = torch.isfinite(g_norm)
    optimizer.step(lr, g_norm, skip=~finite)
    return g_norm, finite, norms


class TrainStep:
    """``step(micro_batches, seed) -> metrics``: one accumulated update of
    ``model`` (built with ``train=True``) on the device its parameters are
    on. ``compute_dtype`` bf16 runs the forward and backward under
    ``torch.autocast``; fp32 runs them in fp32. ``seed`` keys the update's
    dropout masks, as the JAX ``Trainer.train_step``'s (its CLI passes
    ``--seed`` + the updates applied); without it, the constructor's
    ``seed`` + the updates applied."""

    def __init__(self, model, criterion: Callable, optimizer: Optimizer,
                 lr_schedule: Callable[[int], float], compute_dtype=torch.bfloat16,
                 seed: int = 0, mesh=None, pad: Optional[int] = None):
        self.model, self.criterion, self.optimizer = model, criterion, optimizer
        self.lr_schedule = lr_schedule
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.device = self.params[0].device
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.num_updates = 0
        # several ranks: the batch split, the gradients' all-reduce
        self.mesh, self.pad = mesh, pad
        self.data_group = None if mesh is None else mesh.group("data")
        split = getattr(model, "tp_split", {})
        self.model_group = mesh.group("model") if split and mesh is not None else None
        ids = {id(p) for n, p in model.named_parameters() if n in split}
        self.sharded = torch.tensor([id(p) in ids for p in self.params], device=self.device) \
            if split else None
        self.reducer = None
        if self.data_group is not None:
            from ..parallel.reducer import GradientReducer

            self.reducer = GradientReducer(self.params, self.data_group)

    @property
    def num_updates(self) -> int:
        """Updates applied as the host counts them: every dispatched update
        until ``collect`` finds it skipped."""
        return self._num_updates

    @num_updates.setter
    def num_updates(self, n: int) -> None:
        """Sets the count on the host and on the device (a start or a
        restore)."""
        self._num_updates = int(n)
        self.count = torch.tensor(int(n), dtype=torch.int64, device=self.device)

    def autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=self.device.type, dtype=self.compute_dtype)

    def dispatch(self, micro_batches: Iterable[Dict[str, Any]],
                 seed: Optional[int] = None) -> Dict[str, Any]:
        """Queues one accumulated update without reading the device. The
        host's update count is raised at once, as if the update were
        finite; ``collect`` takes it back if it was skipped. ``seed``
        defaults to the constructor's plus the host's count. -> the
        update's results, for ``collect``."""
        if seed is None:
            seed = self.seed + self.num_updates
        self.model.train()
        for p in self.model.parameters():  # trained and frozen
            p.grad = None
        micro_batches = list(micro_batches)
        if self.reducer is not None:
            self.reducer.attach()
        sample_size, totals = 0.0, {}
        for i, batch in enumerate(micro_batches):
            self.generator.manual_seed(microbatch_seed(seed, i))
            weight = 1.0
            if self.mesh is not None:
                from ..parallel.partition import shard_batch

                batch, weight = shard_batch(batch, self.mesh, self.pad)
            if self.reducer is not None and i == len(micro_batches) - 1:
                self.reducer.arm()
            batch = prepare_batch(batch, self.device)
            with self.autocast():
                ss, logging = microbatch_grad(self.model, self.criterion, batch,
                                              self.generator, self.count, weight)
            sample_size += float(ss)
            for k, v in logging.items():
                totals[k] = totals[k] + v if k in totals else v
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.reducer is not None:
            self.reducer.finish()
            sample_size, totals = self._all_reduce_sums(sample_size, totals)
        lr = torch.as_tensor(self.lr_schedule(self.count), dtype=torch.float32,
                             device=self.device)
        g_norm, finite, norms = apply_gradients(self.params, self.optimizer, lr, sample_size,
                                                self.sharded, self.model_group)
        self.count = self.count + finite
        self._num_updates += 1
        on_device = [k for k, v in totals.items() if torch.is_tensor(v)]
        values = torch.stack([g_norm.double(), finite.double(), lr.double(),
                              *(totals[k].detach().double() for k in on_device)])
        return {"values": values, "keys": on_device, "norms": norms,
                "sample_size_total": sample_size,
                "host": {k: float(v) for k, v in totals.items() if not torch.is_tensor(v)}}

    def _all_reduce_sums(self, sample_size: float, totals: Dict[str, Any]):
        """The sample size and the logged sums, summed over the data ranks
        in one all-reduce on the device -> (the sample size, the sums), as
        fp64 tensors on the device (a logged tensor keeps its dtype)."""
        import torch.distributed as dist

        keys = sorted(k for k, v in totals.items()
                      if isinstance(v, (int, float, torch.Tensor)) and not isinstance(v, bool))
        host = [k for k in keys if not torch.is_tensor(totals[k])]
        on_host = torch.tensor([float(sample_size)] + [float(totals[k]) for k in host],
                               dtype=torch.float64)
        if self.device.type == "cuda":
            on_host = on_host.pin_memory()
        sums = torch.cat([on_host.to(self.device, non_blocking=True)]
                         + [totals[k].detach().double().reshape(1) for k in keys
                            if k not in host])
        dist.all_reduce(sums, group=self.data_group)
        out = dict(totals)
        for j, k in enumerate(host):
            out[k] = sums[1 + j]
        for j, k in enumerate([k for k in keys if k not in host]):
            out[k] = sums[1 + len(host) + j].to(totals[k].dtype)
        return sums[0], out

    def collect(self, pending: Dict[str, Any]) -> Dict[str, float]:
        """The metrics of a dispatched update, read from the device;
        ``nonfinite_names`` lists the parameters whose gradient is not
        finite where the update was skipped."""
        values = pending["values"].tolist()
        finite = bool(values[1])
        if not finite:
            self._num_updates -= 1
        metrics = dict(pending["host"])
        metrics.update(zip(pending["keys"], values[3:]))
        metrics.update(gnorm=values[0], sample_size_total=float(pending["sample_size_total"]),
                       nonfinite_grad=0.0 if finite else 1.0, lr=values[2])
        if not finite:
            names = [n for n, p in self.model.named_parameters() if p.requires_grad]
            metrics["nonfinite_names"] = [
                n for n, ok in zip(names, torch.isfinite(pending["norms"]).tolist()) if not ok]
        return metrics

    def __call__(self, micro_batches: Iterable[Dict[str, Any]],
                 seed: Optional[int] = None) -> Dict[str, float]:
        return self.collect(self.dispatch(micro_batches, seed))


def valid_step(model, criterion: Callable, batch: Dict[str, Any]) -> Dict[str, float]:
    """The criterion's logging on one prepared batch in eval mode, without
    gradients; the model's mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            _, _, logging = criterion(model, batch, None, None)
    finally:
        model.train(was_training)
    return {k: float(v) for k, v in logging.items()}
