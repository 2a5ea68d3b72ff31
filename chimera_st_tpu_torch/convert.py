"""Carries weights and optimizer state across between the JAX package's
trees (flax parameter trees, optax Adam state, numpy leaves) and the port's
state dicts (fairseq names).

One table, ``_RULES``, names each module on both sides: a module of the
port's state dict (``encoder.transformer_layers.3.fc1``) and its flax path
(``transformer_layers_3/fc1``), with the kind that says how its leaves map:

- ``dense``  ``weight [out, in]``          <-> ``kernel [in, out]`` (``dense_nobias``:
  without ``bias``, the untied ``output_projection``)
- ``conv``   ``weight [out, in/groups, k]`` <-> ``kernel [k, in/groups, out]``
- ``norm``   ``weight``                     <-> ``scale``
- ``embed``  ``weight``                     <-> ``embedding``

``bias`` keeps its name and layout. ``params_from_flax`` and
``params_to_flax`` read the same table in the two directions, so they
cannot drift apart. The tables are ``interlingua``, ``s2t``, ``wav2vec2``,
``transformer`` (the MT ``TransformerModel``) and ``transformer_lm``;
``model_kind`` names the one of a port model. Every leaf must match a rule and every module must have
all of its kind's leaves, or the conversion raises, as the JAX importer's
completeness check does.

``opt_state_to_optax`` / ``opt_state_from_optax`` map ``torch.optim.Adam``'s
per-parameter state (``step``, ``exp_avg``, ``exp_avg_sq``) to the tree a
JAX ``.ckpt`` of ``--optimizer adam`` holds, and back: optax's chain state
``{"0": {"count", "mu": {"params": …}, "nu": {"params": …}}, "1": {"count"}}``
(``scale_by_adam``, then the schedule's own count), with an empty ``{}`` for
each state without fields: a decoupled weight decay (``adamw``: ``"1"`` is
``{}`` and the schedule moves to ``"2"``), the global-norm clip that
``--clip-norm`` puts first in a chain (``{"0": {}, "1": …}``), and, under a
``--fix-*`` mask, ``optax.multi_transform``'s
``{"inner_states": {"train": {"inner_state": …}, "freeze": {"inner_state": {}}}}``
where each frozen leaf of ``mu`` / ``nu`` is ``{}``. These layouts were read
from the trees the JAX trainer writes.
"""

from __future__ import annotations

import re
from typing import Any, Collection, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]

# kind -> ((torch leaf, flax leaf, required), ...)
_LEAVES = {
    "dense": (("weight", "kernel", True), ("bias", "bias", True)),
    "dense_nobias": (("weight", "kernel", True),),
    "conv": (("weight", "kernel", True), ("bias", "bias", True)),
    "conv_opt_bias": (("weight", "kernel", True), ("bias", "bias", False)),
    "norm": (("weight", "scale", True), ("bias", "bias", True)),
    "embed": (("weight", "embedding", True),),
}


def _to_torch_layout(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and kind.startswith("dense"):
        return a.T
    if leaf == "kernel":  # conv [k, in/g, out] -> [out, in/g, k]
        return a.transpose(2, 1, 0)
    return a


def _to_flax_layout(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "weight" and kind.startswith("dense"):
        return a.T
    if leaf == "weight" and kind.startswith("conv"):
        return a.transpose(2, 1, 0)
    return a


def _enc_layer(t: str, f: str) -> List[Tuple[str, str, str]]:
    rules = [(f"{t}.self_attn.{p}", f"{f}/self_attn/{p}", "dense")
             for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
    rules += [(f"{t}.self_attn_layer_norm", f"{f}/self_attn_layer_norm", "norm"),
              (f"{t}.fc1", f"{f}/fc1", "dense"), (f"{t}.fc2", f"{f}/fc2", "dense"),
              (f"{t}.final_layer_norm", f"{f}/final_layer_norm", "norm")]
    return rules


def _dec_layer(t: str, f: str) -> List[Tuple[str, str, str]]:
    return _enc_layer(t, f) + [
        (f"{t}.encoder_attn.{p}", f"{f}/encoder_attn/{p}", "dense")
        for p in ("q_proj", "k_proj", "v_proj", "out_proj")
    ] + [(f"{t}.encoder_attn_layer_norm", f"{f}/encoder_attn_layer_norm", "norm")]


def _wav2vec2(t: str, f: str) -> List[Tuple[str, str, str]]:
    """The trunk under torch prefix ``t`` / flax prefix ``f`` (``t`` ends
    with a dot, ``f`` with a slash, both empty for a trunk alone)."""
    return [
        (f"{t}feature_extractor.conv_layers.{{i}}.0", f"{f}feature_extractor/conv_{{i}}",
         "conv_opt_bias"),
        (f"{t}feature_extractor.conv_layers.0.2", f"{f}feature_extractor/group_norm", "norm"),
        (f"{t}layer_norm", f"{f}layer_norm", "norm"),
        (f"{t}post_extract_proj", f"{f}post_extract_proj", "dense"),
        (f"{t}encoder.pos_conv.0", f"{f}pos_conv/conv", "conv"),
        *_enc_layer(f"{t}encoder.layers.{{i}}", f"{f}layers_{{i}}"),
        (f"{t}encoder.layer_norm", f"{f}encoder_layer_norm", "norm"),
    ]


def _decoder(cross_attention: bool = True) -> List[Tuple[str, str, str]]:
    layer = _dec_layer if cross_attention else _enc_layer
    return [("decoder.embed_tokens", "decoder/embed_tokens", "embed"),
            *layer("decoder.layers.{i}", "decoder/layers_{i}"),
            ("decoder.layer_norm", "decoder/layer_norm", "norm")]


# the Transformer family's decoder options (JAX transformer_decoder.py:104-117;
# flax names the decoder's embedding LayerNorm after its attribute)
_DECODER_OPTIONS = [
    ("decoder.embed_positions", "decoder/embed_positions", "embed"),
    ("decoder.layernorm_embedding", "decoder/layernorm_embedding_mod", "norm"),
    ("decoder.output_projection", "decoder/output_projection", "dense_nobias"),
]


def _encoder_stacks(*stacks: str) -> List[Tuple[str, str, str]]:
    out = []
    for s in stacks:
        out += _enc_layer(f"encoder.{s}.{{i}}", f"{s}_{{i}}")
    return out


_SUBSAMPLE = [("encoder.subsample.conv_layers.{i}", "subsample/conv_layers_{i}", "conv")]

# model -> (torch module template, flax module template, kind); ``{i}`` is a
# layer index
_RULES = {
    "interlingua": [
        *_wav2vec2("encoder.wav2vec_model.", "wav2vec_model/"),
        *_SUBSAMPLE,
        *[(f"encoder.{n}", n, "embed")
          for n in ("text_embed_tokens", "interlingua_embedding", "modal_embedding")],
        *_encoder_stacks("transformer_layers", "audio_exclusive_layers", "interlingua_layers"),
        ("encoder.layer_norm", "encoder_layer_norm", "norm"),
        *_decoder(),
    ],
    "s2t": [*_SUBSAMPLE, *_encoder_stacks("transformer_layers"),
            ("encoder.layer_norm", "encoder_layer_norm", "norm"), *_decoder()],
    "wav2vec2": _wav2vec2("", ""),
    "transformer": [
        ("encoder.embed_tokens", "embed_tokens", "embed"),
        ("encoder.embed_positions", "embed_positions", "embed"),
        ("encoder.layernorm_embedding", "layernorm_embedding", "norm"),
        *_enc_layer("encoder.layers.{i}", "layers_{i}"),
        ("encoder.layer_norm", "encoder_layer_norm", "norm"),
        *_decoder(), *_DECODER_OPTIONS,
    ],
    "transformer_lm": [*_decoder(cross_attention=False), *_DECODER_OPTIONS],
}


def _pattern(template: str) -> "re.Pattern[str]":
    return re.compile(re.escape(template).replace(re.escape("{i}"), r"(\d+)") + "$")


class _Table:
    """The rules of one model, matched from either side."""

    def __init__(self, rules):
        self.rules = [(t, f, kind, _pattern(t), _pattern(f)) for t, f, kind in rules]

    def from_flax(self, module: str) -> Tuple[str, str]:
        """flax module path ('a/b_3/c') -> (torch module, kind)."""
        for t, _, kind, _, fx in self.rules:
            m = fx.match(module)
            if m:
                return t.replace("{i}", m.group(1)) if m.groups() else t, kind
        raise KeyError(module)

    def from_torch(self, module: str) -> Tuple[str, str]:
        """torch module ('a.b.3.c') -> (flax module path, kind)."""
        for _, f, kind, tx, _ in self.rules:
            m = tx.match(module)
            if m:
                return f.replace("{i}", m.group(1)) if m.groups() else f, kind
        raise KeyError(module)


_TABLES = {name: _Table(rules) for name, rules in _RULES.items()}


def _flatten(tree: Mapping[str, Any], path: Path = ()) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + (str(k),)))
        else:
            out[path + (str(k),)] = v
    return out


def _unflatten(flat: Mapping[Path, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _strip_variables(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def _flax_to_torch_names(table: _Table, leaves: Iterable[Path]) -> Dict[Path, Tuple[str, str]]:
    """flax leaf path -> (torch key, kind); raises on a leaf no rule names
    and on a module that lacks one of its kind's required leaves."""
    modules: Dict[str, Dict[str, Path]] = {}
    for path in leaves:
        modules.setdefault("/".join(path[:-1]), {})[path[-1]] = path
    out, unknown = {}, []
    for module, have in modules.items():
        try:
            tmod, kind = table.from_flax(module)
        except KeyError:
            unknown += [f"{module}/{leaf}" for leaf in have]
            continue
        spec = {fl: (tl, req) for tl, fl, req in _LEAVES[kind]}
        for leaf, path in have.items():
            if leaf not in spec:
                unknown.append(f"{module}/{leaf}")
                continue
            out[path] = (f"{tmod}.{spec[leaf][0]}", kind)
        for fl, (_, req) in spec.items():
            if req and fl not in have:
                raise KeyError(f"flax tree is missing {module}/{fl}")
    if unknown:
        raise ValueError(f"unconsumed flax parameters: {sorted(unknown)[:20]}")
    return out


def _from_flax(model: str, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    flat = _flatten(_strip_variables(tree))
    names = _flax_to_torch_names(_TABLES[model], flat)
    out = {}
    for path, (key, kind) in names.items():
        a = np.asarray(flat[path], dtype=np.float32)
        out[key] = torch.tensor(np.ascontiguousarray(_to_torch_layout(kind, path[-1], a)))
    return out


def torch_to_flax_path(model: str, key: str) -> Tuple[Path, str]:
    """A state-dict key of the port's ``model`` (a table name: 'interlingua',
    's2t', 'wav2vec2', 'transformer', 'transformer_lm') -> (its flax leaf path
    without the 'params' root, kind)."""
    module, _, leaf = key.rpartition(".")
    fmod, kind = _TABLES[model].from_torch(module)
    flax_leaf = {tl: fl for tl, fl, _ in _LEAVES[kind]}.get(leaf)
    if flax_leaf is None:
        raise KeyError(key)
    return tuple(fmod.split("/")) + (flax_leaf,), kind


def _to_flax(model: str, state: Mapping[str, Any]) -> Dict[str, Any]:
    """{torch key: tensor or None} -> the flax tree of numpy leaves (None
    keeps its place as an empty ``{}``, what a masked leaf is in optax)."""
    flat = {}
    for key, value in state.items():
        path, kind = torch_to_flax_path(model, key)
        if value is None:
            flat[path] = {}
            continue
        a = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
        flat[path] = np.ascontiguousarray(_to_flax_layout(kind, key.rpartition(".")[2], a))
    return _unflatten(flat)


def wav2vec2_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``Wav2Vec2Encoder`` params -> state dict of the port's
    ``Wav2Vec2Encoder``."""
    return _from_flax("wav2vec2", tree)


def params_from_flax(tree: Mapping[str, Any], model: str = "interlingua"
                     ) -> Dict[str, torch.Tensor]:
    """Flax params of the JAX ``model`` (a table name: by default
    ``ChimeraInterlinguaModel``) -> state dict of the port's model."""
    return _from_flax(model, tree)


def model_kind(model: torch.nn.Module) -> str:
    """The table name of a port model: ``interlingua``, ``s2t``,
    ``transformer`` or ``transformer_lm``."""
    return {"ChimeraInterlinguaModel": "interlingua", "S2TTransformerModel": "s2t",
            "TransformerModel": "transformer", "TransformerLM": "transformer_lm",
            "Wav2Vec2Encoder": "wav2vec2"}[type(model).__name__]


def s2t_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``S2TTransformerModel`` params -> state dict of the port's
    ``S2TTransformerModel`` (tied decoder embeddings)."""
    return _from_flax("s2t", tree)


def params_to_flax(state_dict: Mapping[str, torch.Tensor], model: str = "interlingua"
                   ) -> Dict[str, Any]:
    """State dict of the port's model -> the flax variables dict
    ``{"params": …}`` of numpy fp32 arrays the JAX package's checkpoints
    hold (the inverse of ``params_from_flax``)."""
    return {"params": _to_flax(model, state_dict)}


# ---------------------------------------------------------------- Adam state

def _optax_wrap(adam: Dict[str, Any], schedule_count: np.ndarray, *, clip: bool,
                decoupled: bool, masked: bool) -> Dict[str, Any]:
    chain = {"0": adam, "1": {}, "2": {"count": schedule_count}} if decoupled \
        else {"0": adam, "1": {"count": schedule_count}}
    if clip:
        chain = {"0": {}, "1": chain}
    if masked:
        chain = {"inner_states": {"train": {"inner_state": chain},
                                  "freeze": {"inner_state": {}}}}
    return chain


def opt_state_to_optax(state: Mapping[str, Optional[Mapping[str, torch.Tensor]]],
                       shapes: Mapping[str, Tuple[int, ...]], schedule_count: int, *,
                       model: str = "interlingua", clip: bool = False,
                       decoupled: bool = False) -> Dict[str, Any]:
    """torch Adam state by parameter name -> optax's tree. ``state[name]``
    is the parameter's ``{"step", "exp_avg", "exp_avg_sq"}``, ``{}`` before
    its first update (zero moments), or None for a frozen parameter (its
    ``mu`` / ``nu`` leaves are ``{}``: the ``multi_transform`` layout).
    ``shapes`` gives every parameter's shape; ``schedule_count`` is the
    updates applied, the schedule's count."""
    masked = any(s is None for s in state.values())
    steps = {int(s["step"]) for s in state.values() if s}
    if len(steps) > 1:
        raise ValueError(f"parameters at different Adam steps {sorted(steps)}")
    count = steps.pop() if steps else 0
    mu, nu = {}, {}
    for name, shape in shapes.items():
        s = state[name]
        if s is None:
            mu[name] = nu[name] = None
        elif not s:
            mu[name] = nu[name] = np.zeros(shape, np.float32)
        else:
            mu[name], nu[name] = s["exp_avg"], s["exp_avg_sq"]
    adam = {"count": np.asarray(count, np.int32),
            "mu": {"params": _to_flax(model, mu)}, "nu": {"params": _to_flax(model, nu)}}
    return _optax_wrap(adam, np.asarray(schedule_count, np.int32), clip=clip,
                       decoupled=decoupled, masked=masked)


def _same_layout(got: Any, want: Any, path: str = "") -> None:
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping) or set(got) != set(want):
            raise ValueError(f"optimizer state layout differs at {path or '/'}: "
                             f"{sorted(got) if isinstance(got, Mapping) else type(got).__name__}"
                             f" vs {sorted(want)}")
        for k in want:
            _same_layout(got[k], want[k], f"{path}/{k}")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"optimizer state {path}: shape {np.shape(got)} vs {np.shape(want)}")


def opt_state_from_optax(tree: Mapping[str, Any], frozen: Collection[str],
                         shapes: Mapping[str, Tuple[int, ...]], *, model: str = "interlingua",
                         clip: bool = False, decoupled: bool = False
                         ) -> Tuple[Dict[str, Optional[Dict[str, torch.Tensor]]], int]:
    """optax's tree -> (torch Adam state by parameter name, the schedule's
    count); the inverse of ``opt_state_to_optax``. The tree must have the
    layout of this optimizer (``clip``, ``decoupled``, the ``frozen``
    names); otherwise ValueError, on which a caller keeps a fresh state as
    the JAX package's ``load_state`` does."""
    template = opt_state_to_optax({n: (None if n in frozen else {}) for n in shapes}, shapes, 0,
                                  model=model, clip=clip, decoupled=decoupled)
    _same_layout(tree, template)
    chain = tree
    if frozen:
        chain = chain["inner_states"]["train"]["inner_state"]
    if clip:
        chain = chain["1"]
    adam = chain["0"]
    schedule_count = int(np.asarray(chain["2" if decoupled else "1"]["count"]))
    count = int(np.asarray(adam["count"]))
    # a masked leaf ({}) flattens away
    mu, nu = _from_flax(model, adam["mu"]), _from_flax(model, adam["nu"])
    out: Dict[str, Optional[Dict[str, torch.Tensor]]] = {}
    for name in shapes:
        if name in frozen:
            out[name] = None
        elif count == 0:
            out[name] = {}
        else:
            out[name] = {"step": torch.tensor(float(count)), "exp_avg": mu[name],
                         "exp_avg_sq": nu[name]}
    return out, schedule_count


def checkpoint_tensors(payload: Mapping[str, Any], shapes: Mapping[str, Tuple[int, ...]],
                       model: str = "interlingua", frozen: Collection[str] = ()):
    """A native checkpoint's payload (any clip or decoupled decay; the
    ``frozen`` parameters masked out of Adam, as ``--fix-*`` or the
    text-only trunk mask leave them) -> (the parameters as a state dict, the
    Adam state by parameter name, the schedule's count): ``params_from_flax``
    and ``opt_state_from_optax`` in one call."""
    params = _from_flax(model, payload["params"])
    tree = payload["opt_state"]
    chain = tree["inner_states"]["train"]["inner_state"] if frozen else tree
    clip = set(chain) == {"0", "1"} and chain["0"] == {}
    chain = chain["1"] if clip else chain
    state, count = opt_state_from_optax(tree, frozen, shapes, model=model, clip=clip,
                                        decoupled="2" in chain)
    return params, state, count
