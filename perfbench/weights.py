"""Seeded weights, drawn on the card in a few large calls and handed alike
to the program and to the plain reference.

The rule of each parameter follows its name and shape, the scales of the
JAX package's initialisers: a bias 0; a vector (a norm's scale) 1; an
embedding table normal(0, d^-0.5); a convolution he-normal (std
sqrt(2 / fan_in)); any other matrix xavier-uniform. One normal draw and one
uniform draw cover every parameter, in the order of their sorted names.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def is_embedding(name: str) -> bool:
    return "embed_tokens" in name or "embedding" in name


def rule(name: str, shape: Tuple[int, ...]) -> str:
    if name.endswith("bias"):
        return "zeros"
    if len(shape) == 1:
        return "ones"
    if is_embedding(name):
        return "embedding"
    if len(shape) == 3:
        return "conv"
    return "xavier"


def seeded_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} for the (name, shape) pairs, from
    ``seed``."""
    items = sorted((n, tuple(s)) for n, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    n_normal = sum(math.prod(s) for n, s in items if rule(n, s) in ("embedding", "conv"))
    n_uniform = sum(math.prod(s) for n, s in items if rule(n, s) == "xavier")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for name, shape in items:
        kind, size = rule(name, shape), math.prod(shape)
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "embedding":
            out[name] = normal[i_n:i_n + size].view(shape) * shape[1] ** -0.5
            i_n += size
        elif kind == "conv":
            fan_in = shape[1] * shape[2]
            out[name] = normal[i_n:i_n + size].view(shape) * math.sqrt(2.0 / fan_in)
            i_n += size
        else:
            fan_out, fan_in = shape[0], math.prod(shape[1:])
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            out[name] = (uniform[i_u:i_u + size].view(shape) * 2.0 - 1.0) * bound
            i_u += size
    return out
