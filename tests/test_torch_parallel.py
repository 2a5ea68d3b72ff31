"""Several ranks of the PyTorch port (``chimera_st_tpu_torch/parallel/``) on
the CPU: one gloo world of 4 processes (one thread each, a ``file://``
rendezvous under the test's directory), started once for the module by
``tests/torch_parallel_worker.py``, runs

- data 4, data 2 x model 2 (tensor parallel), data 2 x model 2 with
  ``--zero-sharding os`` and data 4 with it: two Adam updates of a tiny
  ``transformer_lm`` on two global batches of 8;
- data 2 x pipe 2: the stacked ``transformer_lm_pipe`` through the GPipe
  schedule in 4 chunks, two updates, and one update of a tiny
  ``transformer`` whose encoder and decoder stacks run the schedule (the
  encoder states ride along as each micro-batch's side input);
- ring attention over 4 sequence blocks (a padded batch), its output and
  the gradients of sum(out * R);
- a sharded beam decode of a tiny ``transformer``.

Each result is held against the one-process port run (losses, gradient
norms, gradients and parameters within 1e-5 in fp32; tokens identical)
and against the JAX package's mesh run of the same layout on the forced CPU
devices (``tests/conftest.py``): the train steps of
``tests/test_train_step.py::test_train_step_tp_plus_zero1`` and
``tests/test_pipeline.py``, ``tests/test_ring_attention.py`` and the sharded
decode of ``tests/test_multichip_decode.py``. The last test runs the train
CLI with ``--distributed-world-size 2 --cpu`` against one process."""

import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import chimera_st_tpu.tasks.language_modeling  # noqa: F401 (registers lm_cross_entropy)
from chimera_st_tpu.criterions import CRITERIONS as JAX_CRITERIONS
from chimera_st_tpu.generation.generator import GeneratorSettings as JaxSettings
from chimera_st_tpu.generation.generator import SequenceGenerator as JaxGenerator
from chimera_st_tpu.models import pipeline_lm as jax_pipe
from chimera_st_tpu.models import transformer_mt as jax_mt
from chimera_st_tpu.optim import build_lr_schedule as jax_sched
from chimera_st_tpu.optim import build_optimizer as jax_opt
from chimera_st_tpu.parallel import make_mesh as jax_make_mesh
from chimera_st_tpu.parallel import shard_params
from chimera_st_tpu.parallel.mesh import make_pipeline_mesh as jax_pipeline_mesh
from chimera_st_tpu.parallel.ring_attention import ring_self_attention as jax_ring
from chimera_st_tpu.train import make_train_step
from chimera_st_tpu.train.train_step import create_train_state
from chimera_st_tpu_torch import convert
from tests import torch_parallel_worker as worker

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
MT = dict(src_vocab_size=30, tgt_vocab_size=30, encoder_embed_dim=32, encoder_ffn_dim=48,
          encoder_layers=2, encoder_heads=4, decoder_embed_dim=32, decoder_ffn_dim=48,
          decoder_layers=2, decoder_heads=4, dropout=0.0)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32), tree)


def _batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        tokens = rng.integers(3, 40, size=(8, 12))
        target = np.concatenate([tokens[:, 1:], rng.integers(3, 40, size=(8, 1))], 1)
        for row, n in ((1, 9), (5, 4), (6, 11)):
            tokens[row, n:] = 1
            target[row, n:] = 1
        out.append({"net_tokens": tokens, "target": target,
                    "ntokens": float((target != 1).sum()), "nsentences": 8})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights and inputs (made by flax / numpy, seeded), the world's
    results, and the one-process port runs."""
    work = tmp_path_factory.mktemp("world")
    batches = _batches()
    jlm = jax_mt.build_transformer_lm(dict(worker.LM))
    lm_tree = _noisy(jlm.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]["net_tokens"])), 1)
    pipe_tree = jax_pipe.stack_lm_params(jax.tree_util.tree_map(jnp.asarray, lm_tree), 4)
    pipe_tree = jax.tree_util.tree_map(np.asarray, pipe_tree)
    jmt = jax_mt.build_transformer(dict(MT))
    src = np.random.default_rng(6).integers(3, 30, size=(8, 9)).astype(np.int32)
    src[:, -1] = 2
    src[3, 5:] = 1
    mt_tree = _noisy(jmt.init(jax.random.PRNGKey(1), jnp.asarray(src), jnp.asarray(src[:, :4])),
                     2)
    prev = np.concatenate([np.full((8, 1), 2), src[:, :6]], 1).astype(np.int64)
    tgt = src[:, :7].astype(np.int64)
    tgt[3, 5:] = prev[3, 6:] = 1
    mt_batch = {"src_tokens": src.astype(np.int64), "prev_output_tokens": prev, "target": tgt,
                "ntokens": float((tgt != 1).sum()), "nsentences": 8}
    rng = np.random.default_rng(7)
    q, k, v, r = (rng.normal(size=(2, 32, 4, 8)).astype(np.float32) for _ in range(4))
    pad = np.zeros((2, 32), bool)
    pad[1, 20:] = True
    inputs = {"lm": convert.params_from_flax(lm_tree, "transformer_lm"),
              "lm_pipe": convert.params_from_flax(pipe_tree, "transformer_lm_pipe"),
              "batches": batches, "ring": (q, k, v, pad, r),
              "mt": convert.params_from_flax(mt_tree, "transformer"), "mt_cfg": dict(MT),
              "src": src.astype(np.int64), "mt_batch": mt_batch}
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    torch.multiprocessing.start_processes(
        worker.rank_main, args=(str(work),), nprocs=4, join=True, start_method="spawn")
    world = pickle.loads((work / "results.pkl").read_bytes())
    one = {"lm": worker.train_updates("transformer_lm", inputs["lm"], batches),
           "pipe": worker.train_updates("transformer_lm_pipe", inputs["lm_pipe"], batches),
           "decode": worker.decode_batch(inputs["mt"], MT, inputs["src"]),
           "mt": worker.mt_update(inputs["mt"], MT, mt_batch)}
    return dict(world=world, one=one, batches=batches, lm_tree=lm_tree, pipe_tree=pipe_tree,
                jlm=jlm, jmt=jmt, mt_tree=mt_tree, src=src, inputs=inputs, work=work)


_JAX_RUNS = {}


def _jax_updates(model, tree, batches, mesh, zero=None):
    """Two JAX train steps of the same layout on ``mesh``: (loss, gnorm)
    each, and the final parameters as the port's state dict; each layout
    run once for the module."""
    key = (type(model).__name__, tuple(mesh.shape.items()), zero)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_run(model, tree, batches, mesh, zero)
    return _JAX_RUNS[key]


def _jax_run(model, tree, batches, mesh, zero):
    sched = jax_sched(worker.SCHED)
    tx = jax_opt(worker.OPT, sched, clip_norm=0.0)
    params = shard_params(jax.tree_util.tree_map(jnp.asarray, tree), mesh)
    state = create_train_state(params, tx, mesh=mesh, zero_sharding=zero)
    shardings = jax.tree_util.tree_map(lambda x: x.sharding, state.opt_state) if zero else None
    step = make_train_step(model, JAX_CRITERIONS.get("lm_cross_entropy")({"padding_idx": 1}),
                           tx, lr_schedule=sched, donate=False, opt_state_shardings=shardings)
    metrics = []
    with mesh:
        for i, batch in enumerate(batches):
            b = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data") if np.ndim(v)
                                                                 else P()))
                 for k, v in batch.items() if k != "nsentences"}
            state, m = step(state, b, jax.random.PRNGKey(i))
            metrics.append((float(m["loss"]), float(m["gnorm"])))
    return metrics, jax.tree_util.tree_map(np.asarray, state.params)


def _check_train(got, want, what):
    # every rank took its slice of each global batch, and none ran one whole
    assert got["paths"] == {"train_sliced": len(got["metrics"])}, (what, got["paths"])
    assert want["paths"] == {}, what
    # buckets start their all-reduce while the backward runs
    assert got["buckets"] > 4 and min(got["early"]) > 0, (what, got["buckets"], got["early"])
    for (loss, gnorm, ss), (loss_w, gnorm_w, ss_w) in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose([loss, gnorm], [loss_w, gnorm_w], err_msg=what, **TOL)
        assert ss == ss_w, what
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, atol=1e-6, rtol=1e-5, err_msg=f"{what} {k}")
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("layout", ["data4", "tp", "tp_zero", "zero4"])
def test_lm_updates_equal_one_process_and_the_jax_mesh(setup, layout):
    got, one = setup["world"][layout], setup["one"]["lm"]
    _check_train(got, one, layout)
    devices = jax.devices()[:4]
    mesh = (jax_make_mesh(4, 1, devices=devices) if layout in ("data4", "zero4")
            else jax_make_mesh(2, 2, devices=devices))
    # JAX's ZeRO-1 on a mesh without a model axis changes its own update
    # (ROADMAP C6): there the port is held to JAX's run without it
    metrics, params = _jax_updates(setup["jlm"], setup["lm_tree"], setup["batches"], mesh,
                                   "os" if layout == "tp_zero" else None)
    np.testing.assert_allclose([m[:2] for m in got["metrics"]], metrics, **TOL)
    if layout == "zero4":
        faulty, _ = _jax_updates(setup["jlm"], setup["lm_tree"], setup["batches"], mesh, "os")
        assert abs(faulty[0][1] - metrics[0][1]) > 1e-3  # the first gnorm, before any update
    want = convert.params_from_flax(params, "transformer_lm")
    for k, w in want.items():
        np.testing.assert_allclose(got["params"][k], w.numpy(), err_msg=k, **TOL)
    if "zero" in layout:
        # each rank keeps a slice of the moments, and the saved optax tree is
        # the whole one
        n = 2 if layout == "tp_zero" else 4
        assert got["zero_slice"] == (40 // n, 32)
        mu = got["optax"]["0"]["mu"]["params"]["decoder"]["embed_tokens"]["embedding"]
        assert mu.shape == (40, 32)


def test_gpipe_over_data_2_pipe_2_equals_one_process_and_the_jax_mesh(setup):
    got = setup["world"]["pipe"]
    _check_train(got, setup["one"]["pipe"], "pipe")
    # the stacked model's updates equal the plain LM's
    np.testing.assert_allclose([m[:2] for m in got["metrics"]],
                               [m[:2] for m in setup["one"]["lm"]["metrics"]], **TOL)
    mesh = jax_pipeline_mesh(2, devices=jax.devices()[:4])
    model = jax_pipe.build_transformer_lm_pipe(dict(
        worker.LM, pipeline_stages=2, pipeline_chunks=4, pipeline_mesh=mesh))
    metrics, params = _jax_updates(model, setup["pipe_tree"], setup["batches"], mesh)
    np.testing.assert_allclose([m[:2] for m in got["metrics"]], metrics, **TOL)
    want = convert.params_from_flax(params, "transformer_lm_pipe")
    for k, w in want.items():
        np.testing.assert_allclose(got["params"][k], w.numpy(), err_msg=k, **TOL)


def test_gpipe_of_the_transformer_stacks_equals_one_process(setup):
    (loss, gnorm), grads = setup["world"]["mt_pipe"]
    (loss_w, gnorm_w), want = setup["one"]["mt"]
    np.testing.assert_allclose([loss, gnorm], [loss_w, gnorm_w], **TOL)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, atol=1e-6, rtol=1e-5, err_msg=k)
    assert np.abs(grads["encoder.layers.0.fc1.weight"]).max() > 0  # through the encoder_out


def test_ring_attention_and_its_gradient_equal_dense_and_the_jax_ring(setup):
    q, k, v, pad, r = setup["inputs"]["ring"]
    out, dq, dk, dv = setup["world"]["ring"]
    # the one-process dense attention and its autograd gradients
    from chimera_st_tpu_torch.ops.attention import dot_product_attention

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    dense = dot_product_attention(qt, kt, vt, key_padding_mask=torch.from_numpy(pad))
    (dense * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out, dense.detach().numpy(), **TOL)
    for g, want in ((dq, qt.grad), (dk, kt.grad), (dv, vt.grad)):
        np.testing.assert_allclose(g, want.numpy(), **TOL)
    mesh = JaxMesh(np.array(jax.devices()[:4]), ("seq",))

    def loss(a, b, c):
        return jnp.sum(jax_ring(a, b, c, mesh, jnp.asarray(pad)) * r)

    ref = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                              jnp.asarray(pad)))
    np.testing.assert_allclose(out, ref, **TOL)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, want in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(g, np.asarray(want), **TOL)


def test_sharded_decode_equals_one_process_and_the_jax_mesh(setup):
    tokens, scores, lens, sliced = setup["world"]["decode"]
    t1, s1, l1, _ = setup["one"]["decode"]
    assert sliced  # each rank decoded its quarter
    np.testing.assert_array_equal(lens, l1)
    np.testing.assert_array_equal(tokens, t1)
    np.testing.assert_allclose(scores, s1, **TOL)
    mesh = jax_make_mesh(4, 1, devices=jax.devices()[:4])
    gen = JaxGenerator(setup["jmt"], JaxSettings(beam_size=3, max_decode_len=10, min_len=2))
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, setup["mt_tree"]),
                            NamedSharding(mesh, P()))
    t0, s0, l0 = map(np.asarray, gen.generate_text(
        params, jax.device_put(jnp.asarray(setup["src"]), NamedSharding(mesh, P("data")))))
    np.testing.assert_array_equal(lens, l0)
    np.testing.assert_array_equal(tokens[..., :t0.shape[-1]], t0)
    np.testing.assert_allclose(scores, s0, atol=1e-4, rtol=1e-4)
    assert len({tuple(t) for t in tokens.reshape(-1, tokens.shape[-1])}) > 3


def _lm_corpus(work: Path) -> Path:
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(11)
    for split, n in (("train", 16), ("valid", 4)):
        rows = [" ".join(f"w{i}" for i in rng.integers(0, 20, size=int(rng.integers(4, 12))))
                for _ in range(n)]
        (work / f"{split}.txt").write_text("\n".join(rows) + "\n")
    preprocess.main(["--only-source", "--trainpref", str(work / "train.txt"), "--validpref",
                     str(work / "valid.txt"), "--destdir", str(work / "lm")])
    return work / "lm"


def test_train_cli_with_two_ranks_logs_the_one_process_losses(tmp_path):
    """``cli.train --distributed-world-size 2 --cpu`` (two gloo ranks on this
    host, rank 0 logging) logs the losses of the same run in one process."""
    data = _lm_corpus(tmp_path)
    argv = [str(data), "--task", "language_modeling", "--arch", "transformer_lm",
            "--criterion", "lm_cross_entropy", "--tokens-per-sample", "16", "--batch-size", "4",
            "--optimizer", "adam", "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt",
            "--warmup-updates", "2", "--max-update", "3", "--log-interval", "1",
            "--log-format", "simple", "--disable-validation", "--no-save", "--seed", "3",
            "--embed-dim", "32", "--ffn-dim", "64", "--layers", "2", "--heads", "4",
            "--dropout", "0", "--attention-dropout", "0", "--activation-dropout", "0",
            "--dtype", "float32", "--cpu", "--num-workers", "0"]
    losses = []
    for extra in ([], ["--distributed-world-size", "2"]):
        out = subprocess.run([sys.executable, "-m", "chimera_st_tpu_torch.cli.train", *argv,
                              *extra], cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        losses.append([float(x) for x in re.findall(r"\bloss[ =](\d+\.\d+)", out.stdout)])
        if extra:
            # each rank trained on its half of every batch
            assert "data ranks: 3 batches split, 0 run whole" in out.stdout + out.stderr, \
                out.stdout[-3000:] + out.stderr[-3000:]
    assert len(losses[0]) == 3, losses
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
