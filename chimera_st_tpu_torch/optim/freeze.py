"""Fine-tune freeze controls (counterpart of chimera_st_tpu/optim/freeze.py):
the ``--fix-*`` flags and ``--reset-encoder``.

The JAX package freezes in the optimizer, not in the model: a frozen
subtree gets ``optax.set_to_zero()`` through ``optax.multi_transform``. So a
frozen parameter still has a gradient, which counts in the reported
gradient norm, and it gets no update and holds no Adam moments. The port
does the same: a frozen parameter keeps ``requires_grad`` (its gradient is
computed and counted in the norm) and stays out of the torch optimizer,
which never steps it (``optim.Optimizer``'s ``frozen``). ``--clip-norm``
then clips by the norm of the trained gradients alone, as the clip inside
``multi_transform``'s ``train`` branch sees only those.

Labels are decided on the parameter's flax path (``convert``'s table), by
the JAX package's predicates. ``fix_audio_trunk`` is no CLI flag: the train
CLI adds it for a text-only task (``auto_text_only_fixes``), unless
``--fix-wav2vec`` is given, as the JAX CLI does.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch

from ..convert import torch_to_flax_path

_AUDIO_TRUNK_KEYS = ("wav2vec_model", "subsample")

# flag name -> predicate over the parameter's flax path (below "params")
_FIX_PREDICATES = {
    "fix_wav2vec": lambda p: p and p[0] == "wav2vec_model",
    "fix_encoder_transformers": lambda p: p and p[0].startswith("transformer_layers_"),
    "fix_decoder": lambda p: p and p[0] == "decoder",
    "fix_decoder_transformers": lambda p: len(p) >= 2 and p[0] == "decoder"
    and p[1].startswith("layers_"),
    "fix_interlingua": lambda p: p and (p[0].startswith("interlingua_layers_")
                                        or p[0] == "interlingua_embedding"),
    # the audio-only subtrees, which a text-only task never reaches
    "fix_audio_trunk": lambda p: p and (p[0] in _AUDIO_TRUNK_KEYS
                                        or p[0].startswith("audio_exclusive_layers_")),
}

FIX_FLAG_NAMES: Tuple[str, ...] = tuple(_FIX_PREDICATES)


def freeze_labels(model: torch.nn.Module, fixes: Iterable[str]) -> Dict[str, str]:
    """{parameter name: 'freeze' or 'train'} for the flags ``fixes``."""
    fixes = [f for f in fixes if f]
    for f in fixes:
        if f not in _FIX_PREDICATES:
            raise ValueError(f"unknown freeze flag {f!r}")
    preds = [_FIX_PREDICATES[f] for f in fixes]
    return {name: "freeze" if any(p(torch_to_flax_path("interlingua", name)[0]) for p in preds)
            else "train" for name, _ in model.named_parameters()}


def wrap_freeze(model: torch.nn.Module, fixes: Iterable[str]
                ) -> Tuple[List[torch.nn.Parameter], List[torch.nn.Parameter]]:
    """-> (the parameters the optimizer steps, the frozen ones)."""
    labels = freeze_labels(model, fixes)
    named = list(model.named_parameters())
    return ([p for n, p in named if labels[n] == "train"],
            [p for n, p in named if labels[n] == "freeze"])


def auto_text_only_fixes(task, model: torch.nn.Module) -> Tuple[str, ...]:
    """``("fix_audio_trunk",)`` when ``task`` is text-only and ``model``
    has an audio trunk (the wav2vec2 model, the subsampler or audio-only
    encoder layers), else ``()``.

    The reference's Adam steps only the parameters whose ``.grad`` is set,
    so in the MT stage the trunk never gets Adam moments; the JAX package
    masks it out of the optimizer to the same effect, and the port follows
    it, so that an MT checkpoint's optimizer tree is the same in both."""
    if not getattr(task, "text_only", False):
        return ()
    for name, _ in model.named_parameters():
        if _FIX_PREDICATES["fix_audio_trunk"](torch_to_flax_path("interlingua", name)[0]):
            return ("fix_audio_trunk",)
    return ()


def frozen_fraction(model: torch.nn.Module, fixes: Iterable[str]) -> float:
    """Fraction of scalar parameters frozen (for logging)."""
    labels = freeze_labels(model, fixes)
    tot = frz = 0
    for name, p in model.named_parameters():
        tot += p.numel()
        frz += p.numel() if labels[name] == "freeze" else 0
    return frz / max(tot, 1)


def reset_encoder_subtrees(restored: Mapping[str, torch.Tensor],
                           fresh: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """--reset-encoder: the restored state dict with the shared encoder's
    transformer stack (and the audio-only layers) taken from the freshly
    initialised one."""
    out = dict(restored)
    for key in out:
        if key.startswith(("encoder.transformer_layers.", "encoder.audio_exclusive_layers.")):
            out[key] = fresh[key]
    return out
