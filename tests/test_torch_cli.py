"""The PyTorch port's ``generate`` and ``interactive`` CLIs against the JAX
package's on one synthetic fixture, on the CPU (``--device cpu``, fp32).

The fixture is ``tests/synthetic_data.make_triplet_dir`` (8 wavs, a manifest,
a dictionary, ``config_wave.yaml``) plus a fairseq-layout ``.pt`` of a seeded
``tests/torch_reference.TorchChimera`` (weight-normed ``pos_conv``, the
pretraining-only heads, ``args`` as a Namespace with nested ``w2v_args``) and
native ``.ckpt`` files written by the JAX package's ``save_state``. Both CLIs
must print the same sample ids with identical hypothesis strings (so identical
tokens), scores within 1e-4 (they print as ``:.4f``; fp32 through two encoder
stacks and up to 8 decode steps) and the same corpus score line. Every option
whose feature is not ported raises ``NotImplementedError``."""

import dataclasses
import pickle
import re
from argparse import Namespace
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.checkpoint.store import save_state
from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.cli import interactive as jax_interactive
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch.cli import generate, interactive, options
from chimera_st_tpu_torch.data.dictionary import Dictionary
from tests.synthetic_data import make_triplet_dir
from tests.test_interlingua_model import TINY
from tests.test_torch_models import flax_init
from tests.torch_reference import TorchChimera

SCORE_TOL = 1e-4
COMMON = ["--task", "triplet", "--gen-subset", "test", "--beam", "3", "--max-decode-len", "8",
          "--lenpen", "1.5", "--dtype", "float32"]
# the TINY architecture as the keys of a native checkpoint's model_cfg
TINY_MODEL_CFG = dict(
    arch="s2t_transformer_w2v2_interlingua_base", encoder_embed_dim=16, encoder_ffn_dim=32,
    encoder_layers=2, encoder_heads=2, decoder_embed_dim=16, decoder_ffn_dim=32,
    decoder_layers=2, decoder_heads=2, interlingua_length=4, interlingua_layers=2,
    conv_channels=8, w2v2_embed_dim=16, w2v2_ffn_dim=32, w2v2_layers=2, w2v2_heads=2,
    w2v2_conv_spec=((8, 10, 5), (12, 3, 2)), w2v2_conv_pos=8, w2v2_conv_pos_groups=4,
    max_target_positions=64,
)


def fairseq_args(cfg) -> Namespace:
    """``ckpt['args']`` as a released checkpoint carries it: the trunk's
    dimensions nested under ``w2v_args``."""
    w2v = Namespace(
        encoder_embed_dim=cfg.w2v2_embed_dim, encoder_ffn_embed_dim=cfg.w2v2_ffn_dim,
        encoder_layers=cfg.w2v2_layers, encoder_attention_heads=cfg.w2v2_heads,
        conv_pos=cfg.w2v2_conv_pos, conv_pos_groups=cfg.w2v2_conv_pos_groups,
        conv_feature_layers=str([tuple(layer) for layer in cfg.w2v2_conv_spec]),
    )
    return Namespace(
        encoder_embed_dim=cfg.encoder_embed_dim, encoder_ffn_embed_dim=cfg.encoder_ffn_dim,
        encoder_layers=cfg.encoder_layers, encoder_attention_heads=cfg.encoder_heads,
        decoder_embed_dim=cfg.decoder_embed_dim, decoder_ffn_embed_dim=cfg.decoder_ffn_dim,
        decoder_layers=cfg.decoder_layers, decoder_attention_heads=cfg.decoder_heads,
        interlingua_length=cfg.interlingua_length, interlingua_layers=cfg.interlingua_layers,
        conv_kernel_sizes=",".join(map(str, cfg.conv_kernel_sizes)),
        conv_channels=cfg.conv_channels, activation_fn="relu",
        max_target_positions=cfg.max_target_positions, w2v_args=w2v,
    )


def sharpen(tree):
    """Decoder weights x4: the random TINY decoder is near-uniform, and its
    hypotheses would tie within round-off."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * 4.0
        if "decoder" in jax.tree_util.keystr(path) and "kernel" in jax.tree_util.keystr(path)
        else np.asarray(x), tree)


def write_native(path, params, model_cfg):
    """A native checkpoint through the JAX package's own writer."""
    state = SimpleNamespace(step=0, params=params, opt_state=None)
    save_state(str(path), state, {"model_cfg": dict(model_cfg)}, save_optimizer=False)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    make_triplet_dir(str(root), n=8, seed=3)
    vocab = len(Dictionary.load(str(root / "dict.txt")))
    cfg = dataclasses.replace(TINY, tgt_vocab_size=vocab, src_vocab_size=vocab)

    torch.manual_seed(5)
    tref = TorchChimera(cfg).eval()
    with torch.no_grad():
        # a sharper decoder, and a louder memory bank so that hypotheses and
        # scores depend on the audio (and so on each batch's padded length)
        tref.decoder.embed_tokens.weight.mul_(4.0)
        for name, param in tref.named_parameters():
            if name.endswith(("encoder_attn.v_proj.weight", "encoder_attn.out_proj.weight")):
                param.mul_(4.0)
            elif "interlingua_layers" in name and name.endswith(
                    ("v_proj.weight", "out_proj.weight")):
                param.mul_(3.0)
    sd = dict(tref.state_dict())
    assert "encoder.wav2vec_model.encoder.pos_conv.0.weight_g" in sd  # weight-normed
    sd["encoder.wav2vec_model.mask_emb"] = torch.zeros(cfg.w2v2_embed_dim)
    sd["encoder.wav2vec_model.final_proj.weight"] = torch.zeros(4, cfg.w2v2_embed_dim)
    sd["encoder.wav2vec_model.final_proj.bias"] = torch.zeros(4)
    torch.save({"model": sd, "args": fairseq_args(cfg)}, str(root / "ref.pt"))

    _, params = flax_init(cfg, seed=2)
    write_native(root / "native.ckpt", sharpen(params), TINY_MODEL_CFG)
    with open(root / "wavs.txt", "w") as f:
        for i in (5, 0, 3, 6):
            f.write(f"{root}/wavs/u{i}.wav\n\n")
    return root


def parse(text: str):
    """-> ({sample id: [(score, hypothesis), ...]}, {id: reference}, last line)."""
    hyps, refs = {}, {}
    for line in text.splitlines():
        m = re.match(r"^([HDPTS])-(\d+)\t(.*)$", line)
        if not m:
            continue
        kind, sid, rest = m.group(1), int(m.group(2)), m.group(3)
        if kind == "H":
            score, _, hyp = rest.partition("\t")
            hyps.setdefault(sid, []).append((float(score), hyp))
        elif kind == "T":
            refs[sid] = rest
    return hyps, refs, text.strip().splitlines()[-1] if text.strip() else ""


def kinds(text: str):
    """The protocol skeleton: the line kinds and ids in order."""
    return [m.group(0) for m in re.finditer(r"^[STHDP]-\d+", text, re.M)]


def assert_same_output(got: str, want: str, n_ids: int, nbest: int):
    hyps, refs, last = parse(got)
    want_hyps, want_refs, want_last = parse(want)
    assert kinds(got) == kinds(want)
    assert sorted(hyps) == sorted(want_hyps) and len(hyps) == n_ids
    assert refs == want_refs
    for sid, want_list in want_hyps.items():
        assert len(hyps[sid]) == len(want_list) == nbest
        for (score, hyp), (want_score, want_hyp) in zip(hyps[sid], want_list):
            assert hyp == want_hyp, (sid, hyp, want_hyp)
            assert abs(score - want_score) <= SCORE_TOL + 1e-9, (sid, score, want_score)
    assert last == want_last
    return hyps


def run_generate(module, root, ckpt, extra, out_dir, port: bool):
    out_dir.mkdir()
    argv = [str(root), *COMMON, "--path", str(ckpt), "--results-path", str(out_dir), *extra]
    module.main(argv + (["--device", "cpu"] if port else []))
    return (out_dir / "generate-test.txt").read_text()


GENERATE_CASES = {
    "two_buckets_nbest": ["--batch-size", "4", "--num-length-buckets", "2", "--nbest", "3"],
    "bleu_remove_bpe": ["--batch-size", "8", "--num-length-buckets", "1", "--scoring", "bleu",
                        "--remove-bpe", "sentencepiece"],
    "prefix_size": ["--batch-size", "8", "--num-length-buckets", "1", "--prefix-size", "2"],
    "ngram_temperature": ["--batch-size", "8", "--num-length-buckets", "1",
                          "--no-repeat-ngram-size", "2", "--temperature", "0.7",
                          "--min-len", "3"],
    "per_sentence_lengths_unnormalized": ["--batch-size", "8", "--num-length-buckets", "1",
                                          "--max-len-a", "0.008", "--max-len-b", "0",
                                          "--unnormalized", "--unkpen", "0.5"],
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_pt_matches_jax_cli(fixture, tmp_path, case):
    extra = GENERATE_CASES[case]
    nbest = int(extra[extra.index("--nbest") + 1]) if "--nbest" in extra else 1
    want = run_generate(jax_generate, fixture, fixture / "ref.pt", extra, tmp_path / "jax", False)
    got = run_generate(generate, fixture, fixture / "ref.pt", extra, tmp_path / "port", True)
    hyps = assert_same_output(got, want, n_ids=8, nbest=nbest)
    assert got.strip().splitlines()[-1].startswith("Generate test with beam=3: ")
    if case == "prefix_size":
        _, refs, _ = parse(got)
        for sid, ref in refs.items():
            assert hyps[sid][0][1].split()[:2] == ref.split()[:2]
    if case == "ngram_temperature":
        for sid, hs in hyps.items():
            words = hs[0][1].split()
            bigrams = list(zip(words, words[1:]))
            assert len(bigrams) == len(set(bigrams))


def test_generate_quiet_prints_only_the_score_line(fixture, tmp_path):
    got = run_generate(generate, fixture, fixture / "ref.pt",
                       ["--batch-size", "8", "--quiet", "--scoring", "bleu"],
                       tmp_path / "port", True)
    lines = got.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("Generate test with beam=3: BLEU4 = ")


def test_generate_profile_writes_a_trace(fixture, tmp_path):
    """``--profile DIR`` on the generate CLI (as on interactive, validate
    and eval_lm): the decode loop under torch.profiler, a Chrome trace in
    ``DIR/trace.json``, and the same hypotheses as without it."""
    import json

    flags = ["--batch-size", "8", "--scoring", "bleu"]
    plain = run_generate(generate, fixture, fixture / "ref.pt", flags, tmp_path / "plain", True)
    traced = run_generate(generate, fixture, fixture / "ref.pt",
                          flags + ["--profile", str(tmp_path / "trace")], tmp_path / "port", True)
    assert traced == plain
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_generate_native_ckpt_matches_jax_cli(fixture, tmp_path):
    extra = ["--batch-size", "8", "--num-length-buckets", "1", "--nbest", "2"]
    want = run_generate(jax_generate, fixture, fixture / "native.ckpt", extra,
                        tmp_path / "jax", False)
    got = run_generate(generate, fixture, fixture / "native.ckpt", extra, tmp_path / "port", True)
    assert_same_output(got, want, n_ids=8, nbest=2)


def test_generate_native_s2t_ckpt_matches_jax_generator(fixture, tmp_path):
    """A native ``s2t_transformer_s`` checkpoint (narrowed, raw-wav input with
    ``compute_fbank``) under the ``speech_to_text`` task: the port's CLI
    against the JAX task's batches through the JAX generator."""
    model_cfg = dict(arch="s2t_transformer_s", conv_channels=16, encoder_embed_dim=16,
                     encoder_ffn_dim=32, encoder_layers=2, encoder_heads=2,
                     decoder_embed_dim=16, decoder_ffn_dim=32, decoder_layers=2,
                     decoder_heads=2, compute_fbank=True)
    task = jax_setup_task({"_name": "speech_to_text", "data": str(fixture),
                           "config_yaml": "config_wave.yaml"})
    jax_model = task.build_model(dict(model_cfg))
    dataset = task.dataset("test")
    itr = task.make_batch_iterator(dataset, max_sentences=4, seed=1, num_length_buckets=2)
    batches = list(itr.next_epoch_itr(shuffle=False))
    b0 = batches[0]
    params = jax_model.init(jax.random.PRNGKey(4), jnp.asarray(b0["audio"]),
                            jnp.asarray(b0["audio_padding_mask"]),
                            jnp.asarray(b0["prev_output_tokens"]))
    params = sharpen(params)
    write_native(tmp_path / "s2t.ckpt", params, model_cfg)

    d = task.target_dictionary
    gen = JaxGenerator(jax_model, JaxSettings(beam_size=3, max_decode_len=8, len_penalty=1.5,
                                              min_len=1, max_len_b=200),
                       pad=d.pad(), eos=d.eos(), unk=d.unk())
    want = {}
    for batch in batches:
        tokens, scores, lens = map(np.asarray, gen.generate_audio(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(batch["audio"]),
            jnp.asarray(batch["audio_padding_mask"]),
            src_lengths=jnp.asarray(batch["audio_lengths"])))
        for b, sid in enumerate(batch["id"]):
            want[int(sid)] = (float(scores[b, 0]), d.string(tokens[b, 0, :int(lens[b, 0])]))

    out_dir = tmp_path / "port"
    out_dir.mkdir()
    generate.main([str(fixture), "--task", "speech_to_text", "--gen-subset", "test",
                   "--beam", "3", "--max-decode-len", "8", "--lenpen", "1.5",
                   "--dtype", "float32", "--batch-size", "4", "--num-length-buckets", "2",
                   "--path", str(tmp_path / "s2t.ckpt"), "--results-path", str(out_dir),
                   "--device", "cpu"])
    hyps, _, last = parse((out_dir / "generate-test.txt").read_text())
    assert sorted(hyps) == sorted(want) and len(hyps) == 8
    for sid, (score, hyp) in want.items():
        assert hyps[sid][0][1] == hyp
        assert abs(hyps[sid][0][0] - score) <= SCORE_TOL + 5e-5  # printed as :.4f
    assert last.startswith("Generate test with beam=3: ")


def run_interactive(module, root, ckpt, capsys, port: bool, extra=()):
    argv = [str(root), "--task", "triplet", "--beam", "3", "--max-decode-len", "8",
            "--lenpen", "1.5", "--dtype", "float32", "--path", str(ckpt),
            "--input", str(root / "wavs.txt"), "--buffer-size", "2", "--nbest", "2", *extra]
    capsys.readouterr()
    module.main(argv + (["--device", "cpu"] if port else []))
    return capsys.readouterr().out


@pytest.mark.parametrize("ckpt", ["ref.pt", "native.ckpt"])
def test_interactive_matches_jax_cli(fixture, capsys, ckpt):
    want = run_interactive(jax_interactive, fixture, fixture / ckpt, capsys, False)
    got = run_interactive(interactive, fixture, fixture / ckpt, capsys, True)
    hyps, _, _ = parse(got)
    want_hyps, _, _ = parse(want)
    assert sorted(hyps) == [0, 1, 2, 3] == sorted(want_hyps)
    assert [ln.split("\t")[0] for ln in got.splitlines()] == \
        [ln.split("\t")[0] for ln in want.splitlines()]
    assert [ln for ln in got.splitlines() if ln.startswith("S-")] == \
        [ln for ln in want.splitlines() if ln.startswith("S-")]
    for sid, want_list in want_hyps.items():
        assert len(hyps[sid]) == 2
        for (score, hyp), (want_score, want_hyp) in zip(hyps[sid], want_list):
            assert hyp == want_hyp
            assert abs(score - want_score) <= SCORE_TOL + 1e-9


def test_interactive_text_branch_matches_jax_generate_text(fixture, capsys):
    """A task without ``get_interactive_examples`` reads source sentences:
    the port's text branch (``generate_text``) against the JAX generator on
    the same encoded lines."""
    from chimera_st_tpu.checkpoint.torch_import import (
        import_interlingua_state_dict,
        infer_interlingua_config,
        load_torch_checkpoint,
    )
    from chimera_st_tpu.models.interlingua import ChimeraInterlinguaModel as JaxModel
    from chimera_st_tpu_torch.config.registry import register_task
    from chimera_st_tpu_torch.data.batching import collate_tokens
    from chimera_st_tpu_torch.tasks import TASKS, ChimeraTask

    if "text_lines" not in TASKS:
        @register_task("text_lines")
        class TextLines(ChimeraTask):
            def __init__(self, cfg):
                super().__init__(cfg)
                self.d = Dictionary.load(str(Path(cfg["data"]) / "dict.txt"))

            source_dictionary = property(lambda self: self.d)
            target_dictionary = property(lambda self: self.d)

    lines = ["der hund das haus", "die katze", "auto baum der die das"]
    (fixture / "lines.txt").write_text("\n".join(lines) + "\n")
    d = Dictionary.load(str(fixture / "dict.txt"))
    encoded = [d.encode_line(line) for line in lines]
    src = collate_tokens(encoded, d.pad(), target_len=16)
    ckpt = load_torch_checkpoint(str(fixture / "ref.pt"))
    cfg = infer_interlingua_config(ckpt["args"], tgt_vocab=len(d), src_vocab=len(d))
    gen = JaxGenerator(JaxModel(cfg), JaxSettings(beam_size=3, max_decode_len=8,
                                                  len_penalty=1.5, min_len=1, max_len_b=200),
                       pad=d.pad(), eos=d.eos(), unk=d.unk())
    tokens, scores, lens = map(np.asarray, gen.generate_text(
        {"params": import_interlingua_state_dict(ckpt["model"])}, jnp.asarray(src),
        src_lengths=jnp.asarray([len(e) for e in encoded])))

    capsys.readouterr()
    interactive.main([str(fixture), "--task", "text_lines", "--beam", "3",
                      "--max-decode-len", "8", "--lenpen", "1.5", "--dtype", "float32",
                      "--path", str(fixture / "ref.pt"), "--input", str(fixture / "lines.txt"),
                      "--buffer-size", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    hyps, _, _ = parse(out)
    assert [ln.split("\t", 1)[1] for ln in out.splitlines() if ln.startswith("S-")] == lines
    for b in range(3):
        assert hyps[b][0][1] == d.string(tokens[b, 0, :int(lens[b, 0])])
        assert abs(hyps[b][0][0] - float(scores[b, 0])) <= SCORE_TOL + 5e-5  # :.4f


UNPORTED_FLAGS = {
    "distributed_world_size": ["--distributed-world-size", "2"],
    "model_parallel_size": ["--model-parallel-size", "2"],
    "zero_sharding": ["--zero-sharding", "os"],
    "pipeline_stages": ["--pipeline-stages", "2"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED_FLAGS))
def test_unported_option_raises(fixture, name, monkeypatch):
    """Once refusals naming A12: ``--distributed-world-size 2`` now starts
    two ranks of the decode (the start is recorded here;
    ``tests/test_torch_parallel.py`` decodes over real ranks), and the
    training grid's flags reach no decode, as in the JAX generate CLI."""
    from chimera_st_tpu_torch.parallel import mesh as mesh_mod

    flags = UNPORTED_FLAGS[name]
    argv = [str(fixture), *COMMON, "--device", "cpu", "--path", str(fixture / "ref.pt")]
    if name == "distributed_world_size":
        started = []
        monkeypatch.setattr(mesh_mod, "spawn", lambda fn, n, *a, **k: started.append((n, k)))
        assert generate.main(argv + flags) is None
        assert started == [(2, {"device": "cpu"})]
        return
    p = options.base_parser("generate")
    options.add_generation_args(p)
    args, _ = options.parse_with_model_overrides(p, argv + flags)
    options.require_ported(args)
    assert options.setup_data_mesh(args, "cpu") is None


def test_every_unported_entry_is_exercised():
    """Each row of ``options.UNPORTED`` (the generator's table, empty since
    the A12 rows went) but the interactive CLI's ``--constraints`` has a
    case above."""
    flags = {f for case in UNPORTED_FLAGS.values() for f in case}
    for attr, _, flag, _ in options.UNPORTED:
        if attr in ("constraints", "distributed_init_method"):
            continue
        assert flag.split()[0] in flags, flag


def test_interactive_constraints_raise(fixture):
    with pytest.raises(NotImplementedError, match="--constraints"):
        interactive.main([str(fixture), "--task", "triplet", "--path", str(fixture / "ref.pt"),
                          "--input", str(fixture / "wavs.txt"), "--constraints",
                          "--device", "cpu"])


def test_interactive_refuses_an_argument_it_would_drop(fixture):
    with pytest.raises(ValueError, match="--no-repeat-ngram-size"):
        interactive.main([str(fixture), "--task", "triplet", "--path", str(fixture / "ref.pt"),
                          "--input", str(fixture / "wavs.txt"), "--no-repeat-ngram-size", "2",
                          "--device", "cpu"])


def test_unported_scorer_and_task_raise(fixture):
    """A task or a scorer neither package knows raises ``KeyError``: every
    JAX task (the zoo's dummy and classification tasks since ROADMAP A14d)
    and every JAX scorer, ``chrf`` included, is ported."""
    with pytest.raises(KeyError, match="unknown task 'nope'"):
        generate.main([str(fixture), *COMMON[2:], "--task", "nope",
                       "--path", str(fixture / "ref.pt"), "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown scoring 'nope'"):
        generate.main([str(fixture), *COMMON, "--path", str(fixture / "ref.pt"),
                       "--scoring", "nope", "--device", "cpu"])


def test_device_cuda_without_a_card_raises(fixture):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main([str(fixture), *COMMON, "--path", str(fixture / "ref.pt")])


def test_unconsumed_checkpoint_key_raises(fixture, tmp_path):
    ckpt = torch.load(str(fixture / "ref.pt"), weights_only=False)
    ckpt["model"]["encoder.mystery_module.weight"] = torch.zeros(3)
    torch.save(ckpt, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="unmatched"):
        generate.main([str(fixture), *COMMON, "--path", str(tmp_path / "bad.pt"),
                       "--device", "cpu"])


def test_native_checkpoint_reads_without_jax(fixture):
    """The pickle the JAX trainer wrote holds numpy arrays only."""
    import subprocess
    import sys

    probe = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'chimera_st_tpu'):\n"
        "    sys.modules[n] = None\n"
        "from chimera_st_tpu_torch.checkpoint.store import load_native_checkpoint\n"
        "from chimera_st_tpu_torch.convert import params_from_flax\n"
        "tree, cfg = load_native_checkpoint(sys.argv[1])\n"
        "sd = params_from_flax(tree)\n"
        "print(cfg['arch'], len(sd))\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe, str(fixture / "native.ckpt")],
                          cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    arch, n = proc.stdout.split()
    assert arch == "s2t_transformer_w2v2_interlingua_base" and int(n) > 100
    with open(fixture / "native.ckpt", "rb") as f:
        assert pickle.load(f)["opt_state"] is None
