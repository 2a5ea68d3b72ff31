"""One update of the fine-tune (counterpart of chimera_st_tpu/train/
train_step.py): the same semantics, run eagerly.

- ``prepare_batch``: a collated batch onto the device; int16 wire audio to
  float / 32768, the padding mask rebuilt from ``audio_lengths``.
- ``microbatch_grad``: the criterion on one micro-batch and its backward;
  ``.grad`` sums over micro-batches as the JAX accumulation does.
- ``apply_gradients``: divide by the total sample size, the fp32 global
  norm (reported before any clipping), then the optimizer at the schedule's
  lr; a non-finite norm leaves parameters, optimizer state and the update
  count unchanged. Deciding that is the update's one host sync.
- ``TrainStep``: the accumulated update, bf16 compute under
  ``torch.autocast`` over fp32 parameters, dropout masks from a
  ``torch.Generator`` on the model's device, seeded afresh for each
  micro-batch from the update's seed (``microbatch_seed``), so a resumed
  run draws the masks an uninterrupted one draws.
- ``valid_step``: the criterion in eval mode without gradients.

The learning rate of an update is the schedule at the number of updates
applied before it (optax evaluates it at its count before incrementing).
A parameter the loss does not reach gets a zero gradient, as every leaf of
a JAX gradient tree has one, so Adam decays its moments as optax does.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..optim.optimizers import Optimizer

_TOKEN_KEYS = ("prev_output_tokens", "target", "src_text", "src_tokens", "id")


def prepare_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Arrays of a collated batch -> tensors on ``device`` (token ids as
    int64); other entries (``ntokens``, ``nsentences``) pass through."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if isinstance(value, torch.Tensor):
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
                    num_updates: Optional[int] = None) -> Tuple[float, Dict[str, Any]]:
    """The criterion's loss on one prepared micro-batch, back-propagated
    into the parameters' ``.grad`` -> (sample size, logging)."""
    loss, sample_size, logging = criterion(model, batch, generator, num_updates)
    loss.backward()
    return sample_size, {k: v.detach() if torch.is_tensor(v) else v for k, v in logging.items()}


def microbatch_seed(seed: int, i: int) -> int:
    """The generator's seed for micro-batch ``i`` of the update whose seed
    is ``seed``: the first 64-bit word of ``numpy.random.SeedSequence((seed,
    i))``. The JAX trainer keys micro-batch i with ``fold_in(PRNGKey(seed),
    i)``; the masks differ from JAX's, the keying is the same."""
    return int(np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def apply_gradients(params: Sequence[torch.nn.Parameter], optimizer: Optimizer, lr: float,
                    sample_size: float,
                    logged: Sequence[torch.Tensor] = ()) -> Tuple[float, bool, List[float]]:
    """Normalise the summed gradients by the total sample size, take their
    global norm and, if it is finite, one optimizer update at ``lr``. The
    norm and the ``logged`` scalars come to the host together -> (norm,
    whether it was finite, logged values)."""
    grads = [p.grad for p in params]
    denom = max(float(sample_size), 1.0)
    for g in grads:
        g.div_(denom)
    g_norm = global_norm(grads)
    host = torch.stack([g_norm, *(t.float() for t in logged)]).tolist()
    finite = bool(np.isfinite(host[0]))
    if finite:
        optimizer.step(lr, g_norm)
    return host[0], finite, host[1:]


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
                 seed: int = 0):
        self.model, self.criterion, self.optimizer = model, criterion, optimizer
        self.lr_schedule = lr_schedule
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.device = self.params[0].device
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.num_updates = 0  # updates applied; a skipped one does not count

    def autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=self.device.type, dtype=self.compute_dtype)

    def __call__(self, micro_batches: Iterable[Dict[str, Any]],
                 seed: Optional[int] = None) -> Dict[str, float]:
        if seed is None:
            seed = self.seed + self.num_updates
        self.model.train()
        self.optimizer.optimizer.zero_grad(set_to_none=True)
        for p in self.optimizer.frozen:
            p.grad = None
        sample_size, totals = 0.0, {}
        for i, batch in enumerate(micro_batches):
            self.generator.manual_seed(microbatch_seed(seed, i))
            batch = prepare_batch(batch, self.device)
            with self.autocast():
                ss, logging = microbatch_grad(self.model, self.criterion, batch,
                                              self.generator, self.num_updates)
            sample_size += float(ss)
            for k, v in logging.items():
                totals[k] = totals[k] + v if k in totals else v
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.lr_schedule(self.num_updates)
        on_device = [k for k, v in totals.items() if torch.is_tensor(v)]
        gnorm, finite, values = apply_gradients(self.params, self.optimizer, lr, sample_size,
                                                [totals[k] for k in on_device])
        if finite:
            self.num_updates += 1
        metrics = {k: float(v) for k, v in totals.items() if not torch.is_tensor(v)}
        metrics.update(zip(on_device, values))
        metrics.update(gnorm=gnorm, sample_size_total=sample_size,
                       nonfinite_grad=0.0 if finite else 1.0, lr=lr)
        return metrics


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
