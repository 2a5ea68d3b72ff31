"""wav2vec 2.0 pre-training through the train CLI in the port and in the
JAX package, on the CPU: ``--task audio_pretraining --arch wav2vec2
--criterion wav2vec`` (written by JAX) and Chimera's ``--task
bimodal_pretraining --arch wav2vec2_quasiwave --criterion wav2vec_bimodal``
(written by the port; ``aligning_loss_bimodal``'s loss and gradients are
held in ``tests/test_torch_w2v2_pretrain.py``). Each run writes a
checkpoint that the other package resumes; the resumed run logs the keys
the writer logged, from the next update on. In training the Gumbel noise and the trunk's attention
dropout (0.1, fixed in the JAX config) come from each package's own random
streams, so the resumed values are not compared; the port's ``cli.validate``
of a JAX-written checkpoint gives the validation loss the JAX run logged
(evaluation is deterministic: argmax codes, no dropout), within 1e-5
relative. 2 trunk layers, 32 wide, 4 heads, a 2-layer 16-channel conv
spec; ``--num-workers 1`` (see ``tests/test_torch_w2v2_cli.py``)."""

import shutil

import numpy as np
import pytest

from chimera_st_tpu.cli import train as jax_train
from chimera_st_tpu.logging import metrics as jax_metrics
from chimera_st_tpu_torch.cli import train, validate
from chimera_st_tpu_torch.logging import metrics
from tests.test_torch_mt import _Lines, _load
from tests.test_torch_w2v2_pretrain import write_audio_dir

MODEL = ["--conv-spec", "[(16, 3, 2), (16, 3, 2)]", "--encoder-embed-dim", "32",
         "--encoder-ffn-dim", "64", "--encoder-layers", "2", "--encoder-heads", "4",
         "--conv-pos", "8", "--conv-pos-groups", "4", "--final-dim", "16", "--latent-vars",
         "10", "--num-negatives", "5", "--mask-prob", "0.5", "--mask-length", "3",
         "--min-sample-size", "600", "--max-sample-size", "1000"]
TRAIN = ["--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-4",
         "--lr-scheduler", "polynomial_decay", "--warmup-updates", "1", "--total-num-update",
         "10", "--max-tokens", "2600", "--log-format", "json", "--log-interval", "1",
         "--dtype", "float32", "--num-workers", "1"]
RUNS = {  # name -> (task flags, the writer, the reader)
    "wav2vec": (["--task", "audio_pretraining", "--arch", "wav2vec2", "--criterion", "wav2vec"],
                "jax", "port"),
    "wav2vec_bimodal": (["--task", "bimodal_pretraining", "--arch", "wav2vec2_quasiwave",
                         "--criterion", "wav2vec_bimodal"], "port", "jax"),
}
CLIS = {"jax": (jax_train, "chimera_st_tpu.logging.progress_bar", []),
        "port": (train, "chimera_st_tpu_torch.logging.progress_bar", ["--device", "cpu"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pretrain")
    (work / "audio").mkdir()
    (work / "bimodal").mkdir()
    data = {"audio_pretraining": str(write_audio_dir(work / "audio", n=8)),
            "bimodal_pretraining": str(write_audio_dir(work / "bimodal", n=8, bimodal=True))}
    out = {}
    for name, (flags, writer, reader) in RUNS.items():
        argv = [data[flags[1]], *flags, *MODEL, *TRAIN]
        lines, dirs = {}, {}
        for who, extra in ((writer, ["--max-update", "2"]),
                           (reader, ["--max-update", "3", "--restore-file",
                                     "checkpoint_last.ckpt"])):
            cli, logger, device = CLIS[who]
            dirs[who] = work / f"{name}_{who}"
            if who == reader:
                dirs[who].mkdir()
                shutil.copy(dirs[writer] / "checkpoint_last.ckpt", dirs[who])
            jax_metrics.reset()
            metrics.reset()
            with _Lines(logger) as lines[who]:
                cli.main(argv + ["--save-dir", str(dirs[who]), *extra, *device])
        out[name] = dict(argv=argv, lines=lines, dirs=dirs, writer=writer, reader=reader)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_package_resumes_the_others_pre_training(runs, name):
    r = runs[name]
    written, read = r["lines"][r["writer"]], r["lines"][r["reader"]]
    assert len(written) == 2 and len(read) == 1
    assert set(read[0]) == set(written[0])
    assert read[0]["update"] > written[-1]["update"]
    assert all(np.isfinite(float(v)) for k, v in read[0].items() if k != "epoch")
    assert _load(r["dirs"][r["reader"]] / "checkpoint_last.ckpt")["step"] == 3
    if name == "wav2vec":
        assert {"loss", "contrastive_loss", "diversity_loss", "features_pen",
                "prob_perplexity"} <= set(read[0])


def test_validation_of_a_jax_checkpoint_matches_the_jax_run(runs):
    """The port's validate CLI on the JAX run's last checkpoint: the losses
    the JAX run validated at its end."""
    r = runs["wav2vec"]
    assert r["writer"] == "jax"
    ckpt = r["dirs"]["jax"] / "checkpoint_last.ckpt"
    want = _load(ckpt)["extra"]["val_loss"]
    stats = validate.main([*r["argv"], "--path", str(ckpt), "--device", "cpu"])
    np.testing.assert_allclose(stats["loss"], want, rtol=1e-5)
