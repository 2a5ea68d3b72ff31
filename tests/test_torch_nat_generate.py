"""``cli.generate`` on the non-autoregressive models in both packages on the
CPU: a JAX-written ``.ckpt`` of each of the six models under ``--task
translation_lev`` (``translation_ins`` for the insertion model), decoded
with the refinement flags (``--iter-decode-max-iter``,
``--iter-decode-force-max-iter``, ``--iter-decode-eos-penalty``,
``--iter-decode-with-beam``, ``--retain-iter-history``, ``--print-step``),
the Levenshtein ensemble and the external reranker (an autoregressive
``transformer`` as the last ``--path``): the output protocol lines equal
the JAX CLI's line for line, the I- and E- lines included. Then the JAX
generator's guards against the port's, each raising the same exception
type, the NAT flags refused for an autoregressive model, and a port-written
``.ckpt`` of each model loading in JAX to the same parameters.

Weights: seeded numpy draws over a flax init (``seeded_tree``). Widths:
2 + 2 layers, 32 wide, 4 heads; dictionaries of 23 / 29 symbols; canvases
of 16; fp32."""

import contextlib
import io
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import save_state as jax_save_state
from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.generation.nat_generator import build_nat_generator as jax_build
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch import convert
from chimera_st_tpu_torch.checkpoint.store import save_model
from chimera_st_tpu_torch.cli import generate
from chimera_st_tpu_torch.generation.nat_generator import build_nat_generator
from chimera_st_tpu_torch.tasks import setup_task
from tests.test_torch_nat_models import MODELS_UNDER_TEST, SMALL, jax_init, port_model
from tests.test_torch_transformer import _write_translation_dir, seeded_tree

WIDTHS = {k: v for k, v in SMALL.items() if not k.endswith("vocab_size")}
COMMON = ["--source-lang", "en", "--target-lang", "de", "--gen-subset", "test",
          "--max-decode-len", "16", "--batch-size", "3", "--dtype", "float32",
          "--scoring", "bleu"]
# name -> (checkpoints, flags); a checkpoint is a model of MODELS_UNDER_TEST
# (its seed after the colon) or "ar", the reranker
CASES = {
    "levenshtein": (["levenshtein_transformer"], [
        "--iter-decode-max-iter", "4", "--iter-decode-eos-penalty", "0.5", "--print-step"]),
    "levenshtein_history_forced": (["levenshtein_transformer"], [
        "--iter-decode-max-iter", "5", "--iter-decode-force-max-iter",
        "--retain-iter-history", "--print-step"]),
    "cmlm_length_beam": (["cmlm_transformer"], [
        "--iter-decode-max-iter", "3", "--iter-decode-with-beam", "3", "--print-step"]),
    "cmlm_history": (["cmlm_transformer"], [
        "--iter-decode-max-iter", "3", "--retain-iter-history", "--print-step"]),
    "nat_history": (["nonautoregressive_transformer"], [
        "--iter-decode-max-iter", "2", "--retain-iter-history"]),
    "inat_length_beam": (["iterative_nonautoregressive_transformer"], [
        "--iter-decode-max-iter", "2", "--iter-decode-with-beam", "2"]),
    "nacrf": (["nacrf_transformer"], []),
    "insertion": (["insertion_transformer"], [
        "--iter-decode-max-iter", "5", "--retain-iter-history", "--print-step"]),
    "levenshtein_ensemble": (["levenshtein_transformer", "levenshtein_transformer:7"], [
        "--iter-decode-max-iter", "3", "--iter-decode-eos-penalty", "0.25"]),
    "cmlm_reranker": (["cmlm_transformer", "ar"], [
        "--iter-decode-max-iter", "2", "--iter-decode-with-beam", "3",
        "--iter-decode-with-external-reranker"]),
}


def _model_cfg(name):
    cfg = MODELS_UNDER_TEST[name][1]
    extra = {k: getattr(cfg, k) for k in ("max_predicted_length", "train_steps", "crf_lowrank",
                                          "crf_beam", "max_ins") if hasattr(cfg, k)}
    return {"arch": name, **WIDTHS, **extra}


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """The binarized test split and a JAX-written ``.ckpt`` of every model
    the cases name."""
    root = tmp_path_factory.mktemp("nat_generate")
    data = _write_translation_dir(root)
    ckpts = {}
    for paths, _ in CASES.values():
        for spec in paths:
            if spec in ckpts:
                continue
            if spec == "ar":
                jm = jax_mt.TransformerModel(jax_mt.TransformerMTConfig(**SMALL))
                params = seeded_tree(jax.jit(lambda k: jm.init(
                    k, jnp.zeros((3, 8), jnp.int32), jnp.zeros((3, 5), jnp.int32)))(
                        jax.random.PRNGKey(0)), 9)
                cfg = {"arch": "transformer", **WIDTHS}
            else:
                name, _, seed = spec.partition(":")
                _, params = jax_init(name, int(seed or 0))
                cfg = _model_cfg(name)
            path = root / f"{spec.replace(':', '_')}.ckpt"
            jax_save_state(str(path), SimpleNamespace(step=0, params=params, opt_state=None),
                           {"model_cfg": cfg}, save_optimizer=False)
            ckpts[spec] = str(path)
    return {"root": root, "data": str(data), "ckpts": ckpts}


def protocol(text):
    return [ln for ln in text.splitlines() if ln[:2] in ("S-", "T-", "H-", "D-", "P-", "I-",
                                                          "E-") or ln.startswith("Generate ")]


def _task_flag(paths):
    return "translation_ins" if paths[0].startswith("insertion") else "translation_lev"


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_cli_matches_jax(fx, case, capsys):
    paths, flags = CASES[case]
    argv = [fx["data"], "--task", _task_flag(paths), *COMMON, *flags,
            "--path", ":".join(fx["ckpts"][p] for p in paths)]
    capsys.readouterr()
    jax_generate.main(argv)
    want = protocol(capsys.readouterr().out)
    stats = generate.main(argv + ["--device", "cpu"])
    got = protocol(capsys.readouterr().out)
    assert stats["sentences"] == 6
    assert len(got) == len(want) and got == want
    if "--print-step" in flags:
        assert sum(ln.startswith("I-") for ln in got) == 6
    if "--retain-iter-history" in flags:
        assert any(ln.startswith("E-") for ln in got)


class _Dict:
    def pad(self):
        return 1

    def eos(self):
        return 2

    def bos(self):
        return 0

    def unk(self):
        return 3


GUARDS = {
    "eos_penalty_on_insertion": ("insertion_transformer", dict(iter_decode_eos_penalty=0.5)),
    "length_beam_on_refine": ("levenshtein_transformer", dict(iter_decode_with_beam=2)),
    "history_with_length_beam": ("cmlm_transformer", dict(iter_decode_with_beam=2,
                                                          retain_iter_history=True)),
    "reranker_without_model": ("cmlm_transformer", dict(iter_decode_with_beam=2,
                                                        iter_decode_with_external_reranker=True)),
    "reranker_without_length_beam": ("cmlm_transformer",
                                     dict(iter_decode_with_external_reranker=True)),
}


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_generator_guards_raise_as_jax(guard):
    name, settings = GUARDS[guard]
    cfg = SimpleNamespace(max_decode_len=16, **settings)
    jm = MODELS_UNDER_TEST[name][0](MODELS_UNDER_TEST[name][1])
    model = port_model(name, jm, jax_init(name)[1])
    with pytest.raises(Exception) as want:
        jax_build(jm, cfg, _Dict())
    with pytest.raises(want.type) as got:
        build_nat_generator(model, cfg, _Dict())
    assert str(got.value) == str(want.value)


def test_ar_model_refuses_nat_flags_and_nat_ensembles_refuse(fx):
    """An autoregressive model under translation_lev decodes by beam search
    and refuses the refinement flags (the JAX CLI ignores them); an
    ensemble of CMLM models and ``--lm-path`` over a Levenshtein ensemble
    raise as in JAX; a NAT model refuses the beam search's modes and the
    teacher-forced outputs (``--sampling``, ``--print-alignment``)."""
    base = [fx["data"], "--task", "translation_lev", *COMMON, "--device", "cpu"]
    with pytest.raises(ValueError, match="--iter-decode-max-iter applies to the non-auto"):
        generate.main(base + ["--path", fx["ckpts"]["ar"], "--iter-decode-max-iter", "3"])
    with pytest.raises(NotImplementedError, match="only applies to NAT models"):
        generate.main(base + ["--path", f"{fx['ckpts']['ar']}:{fx['ckpts']['ar']}",
                              "--iter-decode-with-beam", "2",
                              "--iter-decode-with-external-reranker"])
    cmlm = fx["ckpts"]["cmlm_transformer"]
    with pytest.raises(NotImplementedError, match="only supported for levenshtein"):
        generate.main(base + ["--path", f"{cmlm}:{cmlm}"])
    lev = fx["ckpts"]["levenshtein_transformer"]
    with pytest.raises(NotImplementedError, match="--lm-path is not supported for NAT"):
        generate.main(base + ["--path", f"{lev}:{lev}", "--lm-path", fx["ckpts"]["ar"]])
    # the port refuses what its refinement would ignore (the JAX CLI ignores it)
    with pytest.raises(ValueError, match="--sampling applies to the beam search"):
        generate.main(base + ["--path", lev, "--sampling"])
    with pytest.raises(NotImplementedError, match="--score-reference / --print-alignment"):
        generate.main(base + ["--path", lev, "--print-alignment"])


def test_interactive_refuses_the_refinement_flags(fx):
    """The interactive CLI forwards no refinement setting, in JAX as here:
    a set one raises instead of being dropped."""
    from chimera_st_tpu_torch.cli import interactive

    with pytest.raises(ValueError, match="--print-step has no effect on interactive"):
        interactive.main([fx["data"], "--task", "translation_lev", "-s", "en", "-t", "de",
                          "--path", fx["ckpts"]["levenshtein_transformer"], "--print-step",
                          "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(MODELS_UNDER_TEST))
def test_port_written_checkpoint_loads_in_jax(fx, name, tmp_path):
    """``save_model`` of each port model, through the JAX generate CLI's
    loader: every parameter bit for bit; the port rebuilds the same model
    from the stored arch."""
    jm, params = jax_init(name, seed=3)
    model = port_model(name, jm, params)
    path = tmp_path / f"{name}.ckpt"
    save_model(str(path), model, _model_cfg(name))
    task_cfg = {"_name": "translation_ins" if name.startswith("insertion") else "translation_lev",
                "data": fx["data"], "source_lang": "en", "target_lang": "de"}
    with contextlib.redirect_stdout(io.StringIO()):
        _, loaded = jax_generate.load_model_and_params(str(path), jax_setup_task(dict(task_cfg)),
                                                       jnp.float32)
    got = convert.params_from_flax(jax.tree_util.tree_map(np.asarray, loaded), name)
    held = model.state_dict()
    assert set(got) == set(held)
    for k in held:
        assert torch.equal(got[k], held[k]), k
    with open(path, "rb") as f:
        assert pickle.load(f)["extra"]["model_cfg"]["arch"] == name
    back = generate.load_model_and_params(str(path), setup_task(dict(task_cfg)), torch.float32,
                                          "cpu")
    assert type(back) is type(model) and convert.model_kind(back) == name
