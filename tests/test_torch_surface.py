"""The port's surface against the JAX package's, read with ``ast`` (neither
package is imported): every public top-level function or class of
``chimera_st_tpu/`` has a namesake in ``chimera_st_tpu_torch/`` (a function,
a class or a module-level name), or is an architecture preset whose name
the port registers, or has a row in ``JAX_ONLY`` with the port's
counterpart and the reason its name differs. No row may stand for work
not done: each names a counterpart that the port defines, or the library
call that replaces it."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# JAX name -> (the port's counterpart, defined at module level in the port,
# or None where a library call replaces it; why the name differs)
JAX_ONLY = {
    "initialize_distributed_from_args": (
        "initialize_distributed", "the --distributed-* flags -> parallel/mesh.py, "
        "torch.distributed's init with the address, world size and rank given"),
    "init_params_for_task": (
        "init_params", "cli/train.py: init_params_, then --w2v2-model-path"),
    "libnat": ("levenshtein", "the C++ edit distance -> scoring/wer.py (csrc/libbleu.cpp)"),
    "batch_by_size_native": (
        "batch_by_size", "the C++ packer -> data/batching.py (csrc/libbleu.cpp)"),
    "BeamState": ("beam_search", "the search's carry of jax.lax.while_loop -> beam_search's "
                                 "own tensors, an eager loop"),
    "build_model_from_arch": (
        "ChimeraTask", "tasks/base.py ChimeraTask.build_model resolves the arch preset"),
    "maybe_layer_drop": ("layerdrop_keep", "LayerDrop's draw of the layers that run"),
    "xavier_uniform_gain": ("init_params_", "a flax initializer -> models/interlingua.py "
                                            "init_params_"),
    "fairseq_embed_init": ("init_params_", "a flax initializer -> init_params_"),
    "glu": (None, "torch.nn.functional.glu"),
    "conv_output_length": ("extractor_output_length", "the extractor's frame count"),
    "frame_signal": ("logmel_plain", "the framing inside the plain log-mel (ops/fbank.py)"),
    "logmel_numpy": ("logmel_plain", "the host log-mel -> the plain log-mel (ops/fbank.py)"),
    "logmel_jax": ("logmel_plain", "the XLA log-mel -> the plain log-mel (ops/fbank.py)"),
    "fused_encoder_attention": ("encoder_attention", "a Pallas kernel -> K1"),
    "flash_attention_applicable": ("encoder_attention_applicable", "K1's gate"),
    "conv_tail_fused_windows": ("conv_tail", "a Pallas kernel -> K2"),
    "fused_conv_tail": ("conv_tail", "a Pallas kernel -> K2"),
    "conv_tail_reference": ("conv_tail_plain", "K2's plain version"),
    "decode_step_attention": ("decode_attention", "a Pallas kernel -> K3"),
    "logmel_pallas": ("logmel", "a Pallas kernel -> K4"),
    "param_partition_specs": (
        "apply_tensor_parallel", "PartitionSpec helper -> parallel/partition.py by parameter "
                                 "name"),
    "zero1_opt_state_specs": ("ZeroOptimizer", "PartitionSpec helper -> parallel/partition.py"),
    "shard_params": ("shard_state_dict", "PartitionSpec helper -> parallel/partition.py"),
    "create_train_state": ("TrainStep", "TrainState -> TrainStep"),
    "make_train_step": ("TrainStep", "make_train_step -> TrainStep"),
    "make_microbatch_grad_fn": ("microbatch_grad", "a jitted closure -> a function"),
    "make_apply_gradients": ("apply_gradients", "a jitted closure -> a function"),
    "make_valid_step": ("valid_step", "a jitted closure -> a function"),
    "nonfinite_grad_paths": ("TrainStep", "the non-finite leaves' names -> TrainStep's "
                                          "nonfinite_names"),
    "nonfinite_paths_from_flags": ("TrainStep", "-> TrainStep's nonfinite_names"),
}


def _modules(pkg: str):
    for path in sorted((REPO / pkg).rglob("*.py")):
        yield path, ast.parse(path.read_text(encoding="utf-8"))


def _is_preset(node) -> bool:
    return any(isinstance(d, ast.Call) and getattr(d.func, "id", None) ==
               "register_model_architecture" for d in node.decorator_list)


def _surface():
    """(the JAX package's public top-level functions and classes -> their
    registered arch name or None; the port's module-level names; every
    string constant in the port)."""
    jax_names = {}
    for path, tree in _modules("chimera_st_tpu"):
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    and not node.name.startswith("_"):
                arch = None
                if _is_preset(node):
                    arch = next(d.args[1].value for d in node.decorator_list
                                if isinstance(d, ast.Call) and len(d.args) > 1)
                jax_names[node.name] = arch
    port_names, port_strings = set(), set()
    for path, tree in _modules("chimera_st_tpu_torch"):
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                port_names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    if isinstance(t, ast.Name):
                        port_names.add(t.id)
        port_strings.update(n.value for n in ast.walk(tree)
                            if isinstance(n, ast.Constant) and isinstance(n.value, str))
    return jax_names, port_names, port_strings


def test_every_jax_function_and_class_has_a_port_counterpart():
    jax_names, port_names, port_strings = _surface()
    assert len(jax_names) > 500 and len(port_names) > 500
    missing = {n: arch for n, arch in jax_names.items() if n not in port_names}
    presets = {n: arch for n, arch in missing.items() if arch is not None}
    # models/s2t_transformer.py composes the 16-layer presets as f"{arch}p"
    unregistered = sorted(arch for arch in presets.values() if arch not in port_strings
                          and not (arch.startswith("s2t_transformer_") and arch.endswith("p")
                                   and arch[:-1] in port_strings))
    assert not unregistered, f"arch presets the port does not register: {unregistered}"
    rest = sorted(n for n in missing if n not in presets)
    unlisted = [n for n in rest if n not in JAX_ONLY]
    assert not unlisted, f"JAX functions / classes with no port counterpart: {unlisted}"
    # the table holds only names the port lacks, each with a real counterpart
    assert sorted(JAX_ONLY) == rest
    for name, (counterpart, reason) in JAX_ONLY.items():
        assert reason and "not ported" not in reason, name
        assert counterpart is None or counterpart in port_names, (name, counterpart)
    assert len(presets) > 70
