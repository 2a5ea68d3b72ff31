"""The port's weight quantization (``chimera_st_tpu_torch/ops/quantization.py``)
against the JAX package's on the CPU: fake quantization and its
straight-through gradient, the min/max observer, scalar quantization of a
state dict, quant noise given the JAX mask, and product quantization from
the same initial centroids. Inputs are numpy-seeded; scalar results are
bit-equal, PQ centroids within 1e-6 (fp32 means summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.ops import quantization as jq
from chimera_st_tpu_torch.ops import quantization as tq


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"fc1.weight": rng.normal(size=(48, 40)).astype(np.float32),
            "fc1.bias": rng.normal(size=(48,)).astype(np.float32),
            "small.weight": rng.normal(size=(8, 16)).astype(np.float32),
            "emb.weight": (3.0 * rng.normal(size=(130, 37)) + 1.0).astype(np.float32)}


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_and_observer_equal_jax(bits):
    x = _weights()["emb.weight"]
    s, z = tq.int8_params(torch.from_numpy(x), bits)
    rs, rz = jq.int8_params(jnp.asarray(x), bits)
    assert s.item() == float(rs) and z.item() == float(rz)
    got = tq.fake_quant(torch.from_numpy(x), s, z, bits)
    ref = jq.fake_quant(jnp.asarray(x), rs, rz, bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(np.unique(got.numpy())) <= 2 ** bits


def test_straight_through_gradient_equals_jax():
    x = _weights(1)["fc1.weight"]
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    s, z = tq.int8_params(xt.detach())
    (tq.fake_quant(xt, s, z) * torch.from_numpy(g)).sum().backward()
    rs, rz = jq.int8_params(jnp.asarray(x))
    ref = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, rs, rz) * g))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(), g)


def test_scalar_quantization_of_a_state_dict_equals_jax():
    w = _weights(3)
    got = tq.quantize_params_scalar({k: torch.from_numpy(v) for k, v in w.items()})
    ref = jq.quantize_params_scalar({k: jnp.asarray(v) for k, v in w.items()})
    for k in w:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # a bias and a matrix under min_size stay as they are
    assert np.array_equal(got["fc1.bias"].numpy(), w["fc1.bias"])
    assert np.array_equal(got["small.weight"].numpy(), w["small.weight"])
    assert not np.array_equal(got["fc1.weight"].numpy(), w["fc1.weight"])


@pytest.mark.parametrize("in_dim", [40, 37])  # whole blocks, and a partial block
def test_quant_noise_equals_jax_given_its_mask(in_dim):
    p, bs = 0.3, 8
    kernel = np.random.default_rng(4).normal(size=(in_dim, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jq.quant_noise(jnp.asarray(kernel), key, p, bs))
    nb = -(-in_dim // bs)
    mask = np.asarray(jax.random.bernoulli(key, p, (nb, 24)))
    # the port's weight is the kernel transposed, its mask [out, nb]
    got = tq.quant_noise(torch.from_numpy(kernel.T.copy()), p, bs,
                         mask=torch.from_numpy(mask.T.copy()))
    np.testing.assert_array_equal(got.numpy().T, ref)
    # from a generator: blocks dropped whole, every kept element rescaled
    w = torch.from_numpy(kernel.T.copy())
    noisy = tq.quant_noise(w, p, bs, generator=torch.Generator().manual_seed(0))
    dropped = noisy == 0
    for b in range(nb):
        blk = dropped[:, b * bs:(b + 1) * bs]
        assert bool((blk.all(1) | ~blk.any(1)).all())
    torch.testing.assert_close(noisy[~dropped], w[~dropped] / (1 - p), rtol=0, atol=0)


def test_quant_noise_is_unbiased_for_the_remainder_rows():
    """JAX tests/test_misc_fixes.py:59: the mean over many masks of a
    10-row weight with blocks of 8 is the weight, the 2 remainder rows too."""
    w = torch.ones((4, 10))
    gen = torch.Generator().manual_seed(0)
    mean = torch.stack([tq.quant_noise(w, 0.5, 8, generator=gen) for _ in range(4000)]).mean(0)
    torch.testing.assert_close(mean, w, atol=0.06, rtol=0)


def test_product_quantization_equals_jax_from_the_same_centroids():
    w = _weights(5)
    x = w["emb.weight"]
    got = tq.pq_quantize(torch.from_numpy(x), block_size=8, n_centroids=16, n_iter=6, seed=3)
    ref = jq.pq_quantize(x, block_size=8, n_centroids=16, n_iter=6, seed=3)
    np.testing.assert_array_equal(got.assignments.numpy(), np.asarray(ref.assignments))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(ref.centroids),
                               atol=1e-6, rtol=1e-6)
    assert got.shape == ref.shape
    dense = tq.pq_dequantize(got)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jq.pq_dequantize(ref)), atol=1e-6)
    # a gradient reaches the centroids through the gather
    c = got.centroids.clone().requires_grad_()
    tq.pq_dequantize(tq.PQWeight(c, got.assignments, got.shape)).sum().backward()
    assert c.grad.sum().item() == pytest.approx(x.size, abs=1e-3)
    # over a state dict: only the matrices of min_size or more
    sd, books = tq.quantize_params_pq({k: torch.from_numpy(v) for k, v in w.items()},
                                      n_centroids=16, min_size=1000)
    ref_sd, ref_books = jq.quantize_params_pq(w, n_centroids=16, min_size=1000)
    assert sorted(books) == sorted(ref_books) == ["emb.weight", "fc1.weight"]
    for k in w:
        np.testing.assert_allclose(sd[k].numpy(), np.asarray(ref_sd[k]), atol=1e-5, err_msg=k)
