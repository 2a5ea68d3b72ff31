"""The wav2vec 2.0 speech recognition CLIs of the port against the JAX
package's, on the CPU: a CTC fine-tune through ``cli.train --task
audio_pretraining --labels ltr`` (span mask, freeze gate, ``tri_stage``,
``--best-checkpoint-metric wer``), each package resuming the other's
update-2 checkpoint to update 4 with the same logged lines and WER
validations as the other package's resume, then ``cli.generate`` of the checkpoint, greedy and prefix
beam with a seeded ARPA LM: H- / T- lines and the WER line identical. The
undeclared wav2vec flags reach the same config fields in both packages,
and the flags that reach none are dropped in both (ROADMAP C).

The models are 2 trunk layers, 32 wide, 4 heads, over a 2-layer 16-channel
conv spec; every dropout 0. ``--num-workers 1``: with more collate
workers the raw-audio datasets' one numpy stream is drawn from several
threads in no fixed order, in both packages (ROADMAP C). Tolerances:
logged losses 1e-5 relative, gnorm 1e-4 (the CTC recursion's log-space
sums over ~60 frames reach 5e-5 between the two packages' fp32 orders of
operations), the WER exact, hypotheses identical as strings."""

import dataclasses
import shutil

import numpy as np
import pytest

from chimera_st_tpu.cli import generate as jax_generate
from chimera_st_tpu.cli import options as jax_options
from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.logging import metrics as jax_metrics
from chimera_st_tpu.tasks import setup_task as jax_setup_task
from chimera_st_tpu_torch.cli import generate, options, train
from chimera_st_tpu_torch.logging import metrics
from chimera_st_tpu_torch.tasks import setup_task
from tests.test_torch_ctc_decode import seeded_arpa
from tests.test_torch_mt import TIMED, _Lines, _load
from tests.test_torch_w2v2_pretrain import write_audio_dir

ASR = ["--task", "audio_pretraining", "--labels", "ltr", "--arch", "wav2vec_ctc",
       "--criterion", "ctc", "--conv-spec", "[(16, 3, 2), (16, 3, 2)]",
       "--w2v2-embed-dim", "32", "--w2v2-ffn-dim", "64", "--w2v2-layers", "2",
       "--w2v2-heads", "4", "--w2v2-conv-pos", "8", "--w2v2-conv-pos-groups", "4",
       "--min-sample-size", "600", "--max-sample-size", "1300"]
TRAIN = ["--apply-mask", "--mask-prob", "0.5", "--mask-length", "3",
         "--freeze-finetune-updates", "1", "--feature-grad-mult", "0.0", "--final-dropout",
         "0.0", "--encoder-layerdrop", "0.05", "--optimizer", "adam", "--adam-betas",
         "(0.9, 0.98)", "--lr", "1e-3", "--lr-scheduler", "tri_stage", "--phase-ratio",
         "[0.25, 0.25, 0.5]", "--final-lr-scale", "0.05", "--max-update", "4",
         "--save-interval-updates", "2", "--max-tokens", "2600",
         "--best-checkpoint-metric", "wer", "--log-format", "json", "--log-interval", "1",
         "--dtype", "float32", "--num-workers", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run and a port run from scratch to update 2; each package then
    resumes each one's update-2 checkpoint to update 4. (A resumed run's
    span masks are not an uninterrupted run's, in either package: the
    dataset's numpy stream restarts from seed 1; ROADMAP C.)"""
    work = tmp_path_factory.mktemp("asr")
    (work / "data").mkdir()
    data = str(write_audio_dir(work / "data", n=9, labels=True))
    argv = [data, *ASR, *TRAIN]
    out = {"data": data, "work": work}
    for name, first in (("jax_ckpt", jax_train), ("port_ckpt", train)):
        a = work / name
        _fresh_meters()
        first.main(argv + ["--save-dir", str(a), "--max-update", "2", *_device(first)])
        for second in (jax_train, train):
            b = work / f"{name}_{_tag(second)}"
            b.mkdir()
            _fresh_meters()
            shutil.copy(a / "checkpoint_1_2.ckpt", b / "checkpoint_1_2.ckpt")
            with _Lines(_logger(second)) as lines:
                second.main(argv + ["--save-dir", str(b), "--restore-file",
                                    "checkpoint_1_2.ckpt", *_device(second)])
            out[f"{name}_{_tag(second)}"] = dict(dir=b, lines=lines)
    return out


def _fresh_meters():
    """Each run starts without the meters an earlier run of this process
    left in either package's global aggregators."""
    jax_metrics.reset()
    metrics.reset()


def _tag(module):
    return "port" if module is train else "jax"


def _device(module):
    return ["--device", "cpu"] if module is train else []


def _logger(module):
    return ("chimera_st_tpu_torch.logging.progress_bar" if module is train
            else "chimera_st_tpu.logging.progress_bar")


@pytest.mark.parametrize("written_by", ["jax_ckpt", "port_ckpt"])
def test_each_package_resumes_the_others_fine_tune(runs, written_by):
    """Both packages resume the same update-2 checkpoint (written by JAX,
    or by the port) to update 4: the same logged lines (loss, gnorm, lr),
    the same validation WER saved as the best."""
    got, want = runs[f"{written_by}_port"], runs[f"{written_by}_jax"]
    assert [line["update"] for line in got["lines"]] == [ln["update"] for ln in want["lines"]]
    assert len(got["lines"]) == 2
    for line, ref in zip(got["lines"], want["lines"]):
        assert set(line) == set(ref)
        for key, value in line.items():
            if key in TIMED or value == ref[key]:
                continue
            np.testing.assert_allclose(float(value), float(ref[key]),
                                       rtol=1e-4 if key == "gnorm" else 1e-5,
                                       err_msg=f"update {line['update']}: {key}")
    a, b = (_load(r["dir"] / "checkpoint_last.ckpt") for r in (got, want))
    assert a["step"] == b["step"] == 4
    assert a["extra"]["val_loss"] == b["extra"]["val_loss"]
    assert a["extra"]["best"] == b["extra"]["best"]


@pytest.mark.parametrize("decode", ["greedy", "beam_lm"])
def test_generate_cli_recognises_as_the_jax_cli(runs, tmp_path, capsys, decode):
    """``cli.generate`` of the port's fine-tuned checkpoint: the same H- and
    T- lines and WER line as the JAX CLI's; greedy at beam 1, prefix beam 8
    fused with a seeded 3-gram ARPA LM."""
    flags = ["--beam", "1"] if decode == "greedy" else [
        "--beam", "8", "--ctc-lm-path", seeded_arpa(tmp_path / "lm.arpa"), "--ctc-lm-weight",
        "0.5"]
    argv = [runs["data"], *ASR, "--path", str(runs["jax_ckpt_port"]["dir"] / "checkpoint_last.ckpt"),
            "--gen-subset", "valid", "--max-tokens", "2600", "--dtype", "float32", *flags]
    texts = []
    for main, extra in ((jax_generate.main, []), (generate.main, ["--device", "cpu"])):
        main(argv + extra)
        texts.append(capsys.readouterr().out)
    lines = [sorted(ln for ln in t.splitlines() if ln[:2] in ("H-", "T-")) for t in texts]
    assert lines[0] == lines[1] and len(lines[0]) == 18
    assert texts[0].strip().splitlines()[-1] == texts[1].strip().splitlines()[-1]
    assert "WER" in texts[1].strip().splitlines()[-1]


@pytest.mark.parametrize("arch, flags", [
    ("wav2vec_ctc", TRAIN),
    # fairseq's names of the trunk's rates: the ASR config's are w2v2_*
    ("wav2vec_ctc", ["--dropout", "0.2", "--attention-dropout", "0.2",
                     "--activation-dropout", "0.1"]),
    # the pre-training task builds its model without the arch's preset
    ("wav2vec2_large", []),
    ("wav2vec_seq2seq", ["--autoregressive", "--decoder-layers", "1", "--decoder-embed-dim",
                         "48", "--layerdrop", "0.1", "--w2v-path", "w.pt"]),
    ("wav2vec2", ["--encoder-heads", "4", "--num-negatives", "7", "--final-dim", "8",
                  "--latent-vars", "5", "--encoder-layerdrop", "0.1", "--loss-weights",
                  "[0.1, 10]", "--dropout", "0.0"]),
])
def test_undeclared_flags_reach_the_same_config_fields(runs, arch, flags):
    """Each wav2vec flag that no parser declares reaches the same model
    config field in both packages; a name the JAX config does not know
    (``--encoder-layerdrop``, ``--w2v-path``, ``--loss-weights``) is
    dropped in both."""
    argv = [runs["data"], "--task", "audio_pretraining", "--arch", arch, *flags]
    if arch.startswith("wav2vec_"):
        argv += ["--labels", "ltr"]
    cfgs = []
    for opts, setup in ((jax_options, jax_setup_task), (options, setup_task)):
        p = opts.base_parser("x")
        opts.add_train_args(p)
        args, extra = opts.parse_with_model_overrides(p, argv)
        task = setup({"_name": args.task, "data": args.data, **extra})
        model_cfg = {"arch": args.arch, **extra}
        if args.feature_grad_mult != 1.0:
            model_cfg["feature_grad_mult"] = args.feature_grad_mult
        kw = {} if setup is jax_setup_task else {"device": "cpu"}
        cfgs.append(dataclasses.asdict(task.build_model(model_cfg, **kw).cfg))
    assert cfgs[0] == cfgs[1]
    if arch == "wav2vec_ctc" and "--dropout" in flags:
        assert (cfgs[1]["w2v2_dropout"], cfgs[1]["w2v2_attention_dropout"],
                cfgs[1]["w2v2_activation_dropout"]) == (0.0, 0.0, 0.0)
    if arch == "wav2vec2_large":
        assert (cfgs[1]["encoder_embed_dim"], cfgs[1]["extractor_mode"]) == (768, "default")


def test_fine_tune_refuses_a_pretrained_trunk_path(runs, tmp_path):
    """``--w2v2-model-path`` loads the interlingua model's trunk only: the
    JAX CLI ignores it for ``wav2vec_ctc`` (and ``--w2v-path`` reaches no
    config), the port's CLI refuses it."""
    with pytest.raises(ValueError, match="--w2v2-model-path"):
        train.main([runs["data"], *ASR, *TRAIN, "--w2v2-model-path", "w.pt", "--save-dir",
                    str(tmp_path), "--device", "cpu"])
