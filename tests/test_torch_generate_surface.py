"""The generation surface of the port's ``generate`` and ``interactive``
CLIs against the JAX CLIs' output, line for line, on the CPU (fp32): several
``--path`` checkpoints (an ensemble of a fairseq ``.pt`` and a native
``.ckpt``), ``--score-reference``, ``--print-alignment``, ``--replace-unk``,
``--diverse-beam-groups``, ``--diversity-rate``, ``--kv-cache-int8``,
``--sampling`` at top-k 1 (deterministic) and ``interactive --constraints
ordered|unordered``.

Audio cases run on the triplet fixture of ``tests/test_torch_cli.py``; text
cases (unknown-word replacement, constraints) on a binarized translation
corpus with a seeded ``.pt`` whose ``<unk>`` output row copies (x1.02) the
row its decoder favours, so that hypotheses hold ``<unk>``; the text case
with ``--print-alignment`` prints the A- lines (on audio the JAX CLI's eager
alignment pass costs a minute here; ``tests/test_torch_ensemble.py`` holds
the audio alignment weights). Every line must be the JAX CLI's, numbers
within 1e-4 plus the printed rounding (W- lines carry wall times and are
left out)."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.cli import interactive as jax_interactive
from chimera_st_tpu.cli import preprocess as jax_preprocess
from chimera_st_tpu_torch.cli import generate, interactive
from chimera_st_tpu_torch.data.dictionary import Dictionary
from tests.synthetic_data import make_parallel_text
from tests.test_interlingua_model import TINY
from tests.test_torch_cli import COMMON, fairseq_args, fixture  # noqa: F401
from tests.torch_reference import TorchChimera

NUM = re.compile(r"-?\d+\.\d{4}")


def assert_same_lines(got: str, want: str):
    """Line for line; the 4-decimal numbers within 1e-4 + 1e-4, everything
    else equal."""
    got_lines = [ln for ln in got.splitlines() if not ln.startswith("W-")]
    want_lines = [ln for ln in want.splitlines() if not ln.startswith("W-")]
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        for a, b in zip(NUM.findall(g), NUM.findall(w)):
            assert abs(float(a) - float(b)) <= 2e-4, (g, w)


@pytest.fixture(scope="module")
def text_fixture(tmp_path_factory):
    """A joined-dictionary data-bin of 32 / 8 sentence pairs (the JAX
    preprocess CLI) and a seeded ``.pt`` of the TINY model over it."""
    work = tmp_path_factory.mktemp("surface")
    raw = make_parallel_text(str(work / "raw"))
    data = work / "bin"
    jax_preprocess.main(["-s", "de", "-t", "en", "--trainpref", f"{raw}/train",
                         "--validpref", f"{raw}/valid", "--testpref", f"{raw}/valid",
                         "--destdir", str(data), "--joined-dictionary"])
    vocab = len(Dictionary.load(str(data / "dict.en.txt")))
    cfg = dataclasses.replace(TINY, tgt_vocab_size=vocab, src_vocab_size=vocab)
    torch.manual_seed(9)
    tref = TorchChimera(cfg).eval()
    with torch.no_grad():
        tref.decoder.embed_tokens.weight.mul_(4.0)
        for name, param in tref.named_parameters():
            if name.endswith(("encoder_attn.v_proj.weight", "encoder_attn.out_proj.weight")):
                param.mul_(4.0)
        # the <unk> output row a little above the row of the token this
        # random decoder prefers, so that hypotheses hold <unk>
        src = torch.tensor([[5, 9, 4, 7, 2], [11, 6, 8, 2, 1]])
        mem = tref.encode_text(src)
        logits = tref.decode(torch.full((2, 1), 2), mem)[:, -1]
        favourite = int(torch.mode(logits[:, 4:].argmax(dim=-1) + 4).values)
        tref.decoder.embed_tokens.weight[3] = 1.02 * tref.decoder.embed_tokens.weight[favourite]
    torch.save({"model": dict(tref.state_dict()), "args": fairseq_args(cfg)},
               str(work / "text.pt"))
    (work / "lex.txt").write_text("der the\nhund dog\nkatze cat\nhaus house\n")
    src = (work / "raw" / "valid.de").read_text().splitlines()[:4]
    (work / "constrained.txt").write_text(
        f"{src[0]}\tthe dog\n{src[1]}\tcat\ta\n{src[2]}\n{src[3]}\thouse\truns\n")
    return work


AUDIO_CASES = {
    "ensemble_pt_ckpt": ["--path", "{root}/ref.pt:{root}/native.ckpt", "--nbest", "2"],
    "score_reference": ["--score-reference"],
    "diverse_groups_int8": ["--beam", "4", "--diverse-beam-groups", "2",
                            "--diverse-beam-strength", "0.7", "--kv-cache-int8", "--nbest", "4"],
    "diversity_rate": ["--diversity-rate", "0.5", "--nbest", "3"],
    "sampling_topk_1": ["--sampling", "--sampling-topk", "1", "--beam", "2", "--nbest", "2",
                        "--seed", "3"],
    "kv_cache_int8": ["--kv-cache-int8", "--nbest", "3", "--lenpen", "1.0"],
}


@pytest.mark.parametrize("case", sorted(AUDIO_CASES))
def test_audio_generate_surface_matches_jax_cli(fixture, tmp_path, case):  # noqa: F811
    extra = [a.format(root=fixture) for a in AUDIO_CASES[case]]
    if "--path" not in extra:
        extra += ["--path", str(fixture / "ref.pt")]
    argv = [str(fixture), *COMMON, "--batch-size", "4", "--num-length-buckets", "2",
            "--scoring", "bleu", *extra]
    outs = {}
    for name, main, dev in (("jax", jax_generate.main, []), ("port", generate.main,
                                                             ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        main(argv + ["--results-path", str(tmp_path / name)] + dev)
        outs[name] = (tmp_path / name / "generate-test.txt").read_text()
    assert_same_lines(outs["port"], outs["jax"])
    kinds = {ln.split("-")[0] for ln in outs["port"].splitlines() if "\t" in ln}
    if case == "score_reference":
        assert kinds == {"T", "H", "P"}
    else:
        assert outs["port"].splitlines()[-1].startswith("Generate test with beam=")


TEXT_CASES = {
    "replace_unk_lexicon_alignment": ["--replace-unk", "{work}/lex.txt", "--print-alignment"],
    "replace_unk_copy_int8": ["--replace-unk", "--kv-cache-int8", "--nbest", "2"],
}


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_text_generate_surface_matches_jax_cli(text_fixture, tmp_path, case):
    work = text_fixture
    extra = [a.format(work=work) for a in TEXT_CASES[case]]
    base = [str(work / "bin"), "--task", "translation", "--path", str(work / "text.pt"),
            "--gen-subset", "test", "--beam", "3", "--max-decode-len", "8", "--batch-size", "4",
            "--dtype", "float32", "--num-length-buckets", "2", "--scoring", "bleu"]
    outs = {}
    for name, main, dev in (("jax", jax_generate.main, []), ("port", generate.main,
                                                             ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        main(base + extra + ["--results-path", str(tmp_path / name)] + dev)
        outs[name] = (tmp_path / name / "generate-test.txt").read_text()
    assert_same_lines(outs["port"], outs["jax"])
    if "--print-alignment" in extra:
        assert sum(ln.startswith("A-") for ln in outs["port"].splitlines()) == 8
    # without --replace-unk the best hypotheses hold <unk>; with it they do not
    (tmp_path / "plain").mkdir()
    generate.main(base + [a for a in ("--kv-cache-int8",) if a in extra]
                  + ["--results-path", str(tmp_path / "plain"), "--device", "cpu"])

    def best(text):
        first = {}
        for ln in text.splitlines():
            if ln.startswith("H-"):
                first.setdefault(ln.split("\t")[0], ln.split("\t")[2].split())
        return first

    before, after = best((tmp_path / "plain" / "generate-test.txt").read_text()), \
        best(outs["port"])
    assert sum("<unk>" in h for h in before.values()) >= 2
    assert not any("<unk>" in h for h in after.values())


@pytest.mark.parametrize("mode", ["ordered", "unordered"])
def test_interactive_constraints_match_jax_cli(text_fixture, capsys, mode):
    """Tab-separated constraint phrases after each source sentence (one line
    without any): the JAX interactive CLI's lines, and each best hypothesis
    holds its phrases (in order for ``ordered``)."""
    work = text_fixture
    argv = [str(work / "bin"), "--task", "translation", "-s", "de", "-t", "en",
            "--path", str(work / "text.pt"), "--beam", "4", "--max-decode-len", "10",
            "--dtype", "float32", "--input", str(work / "constrained.txt"),
            "--buffer-size", "4", "--nbest", "2", "--constraints", mode]
    capsys.readouterr()
    jax_interactive.main(argv)
    want = capsys.readouterr().out
    interactive.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert_same_lines(got, want)
    lines = (work / "constrained.txt").read_text().splitlines()
    best = [ln.split("\t")[2].split() for ln in got.splitlines() if ln.startswith("H-")][::2]
    for hyp, line in zip(best, lines):
        phrases = [p.split() for p in line.split("\t")[1:]]
        starts = [next(j for j in range(len(hyp)) if hyp[j:j + len(p)] == p) for p in phrases]
        if mode == "ordered":
            assert starts == sorted(starts), (hyp, phrases)


def test_ensemble_refuses_single_model_options(fixture):  # noqa: F811
    argv = [str(fixture), *COMMON, "--path", f"{fixture}/ref.pt:{fixture}/native.ckpt",
            "--device", "cpu"]
    for flags, match in ((["--sampling"], "plain beam search"),
                         (["--diverse-beam-groups", "3"], "plain beam search"),
                         (["--retain-dropout"], "--retain-dropout"),
                         (["--kv-cache-int8"], "--kv-cache-int8"),
                         (["--prefix-size", "1"], "--prefix-size")):
        with pytest.raises(NotImplementedError, match=match):
            generate.main(argv + flags)


FORMERLY_UNPORTED = {
    "sampling_topp": ["--sampling", "--sampling-topp", "0.9"],
    "retain_dropout": ["--retain-dropout"],
    "score_reference_retain_dropout": ["--score-reference", "--retain-dropout"],
}


@pytest.mark.parametrize("name", sorted(FORMERLY_UNPORTED))
def test_stochastic_options_run_and_repeat(fixture, tmp_path, name):  # noqa: F811
    """Options whose draws cannot equal the JAX package's: the CLI runs, prints
    a hypothesis (or a scored reference) per sample, and the same seed repeats
    the output."""
    argv = [str(fixture), *COMMON, "--path", str(fixture / "ref.pt"), "--batch-size", "8",
            "--scoring", "bleu", "--device", "cpu", *FORMERLY_UNPORTED[name]]
    outs = []
    for run in ("a", "b"):
        (tmp_path / run).mkdir()
        generate.main(argv + ["--results-path", str(tmp_path / run)])
        outs.append((tmp_path / run / "generate-test.txt").read_text())
    assert outs[0] == outs[1]
    assert len([ln for ln in outs[0].splitlines() if ln.startswith("H-")]) == 8
    assert np.isfinite([float(ln.split("\t")[1]) for ln in outs[0].splitlines()
                        if ln.startswith("H-")]).all()


@pytest.mark.parametrize("flags", [["--sampling"], ["--print-alignment"],
                                   ["--replace-unk"], ["--retain-dropout"]],
                         ids=lambda f: f[0])
def test_interactive_refuses_generate_only_options(fixture, flags):  # noqa: F811
    with pytest.raises(ValueError, match=flags[0]):
        interactive.main([str(fixture), "--task", "triplet", "--path", str(fixture / "ref.pt"),
                          "--input", str(fixture / "wavs.txt"), "--device", "cpu", *flags])
