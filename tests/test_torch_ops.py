"""Parity of the PyTorch port's kernel modules with the JAX package, on the
CPU, where each wrapper takes its kernel's plain PyTorch version.

The same numpy inputs go through the JAX function and the port. Tolerances
are fp32 reordering noise (1e-5) unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chimera_st_tpu.models.layers import MultiheadAttention as JaxMHA
from chimera_st_tpu.ops.attention import dot_product_attention as jax_attention
from chimera_st_tpu.ops.pallas_attention import fused_encoder_attention
from chimera_st_tpu.ops.pallas_conv import TAIL_SPEC, conv_tail_reference
from chimera_st_tpu_torch.models.layers import MultiheadAttention
from chimera_st_tpu_torch.ops import conv_tail, decode_attention, encoder_attention, logmel


def _qkv(rng, B, T, H, D):
    return [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("D", [64, 96])
def test_encoder_attention_matches_jax(D):
    """K1's plain version vs JAX dot_product_attention and the Pallas kernel
    (interpret mode), with an unpadded and a partly padded row; 1e-5."""
    rng = np.random.default_rng(D)
    B, T, H = 2, 40, 2
    q, k, v = _qkv(rng, B, T, H, D)
    mask = np.zeros((B, T), bool)
    mask[1, 25:] = True
    got = encoder_attention.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                              torch.from_numpy(mask)).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    np.testing.assert_allclose(got, np.asarray(jax_attention(jq, jk, jv, key_padding_mask=jm)),
                               atol=1e-5, rtol=1e-5)
    pallas = fused_encoder_attention(jq, jk, jv, jm, float(D**-0.5), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)


def test_encoder_attention_fully_padded_row_follows_xla_path():
    """A query row whose keys are all padding averages V uniformly over the
    T real keys, as JAX dot_product_attention does (-1e8 is finite). The
    Pallas kernel averages over its 128-padded width instead: a deliberate
    divergence, the port follows the XLA path."""
    rng = np.random.default_rng(7)
    B, T, H, D = 2, 40, 2, 64
    q, k, v = _qkv(rng, B, T, H, D)
    mask = np.zeros((B, T), bool)
    mask[0, :] = True
    got = encoder_attention.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                              torch.from_numpy(mask)).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    ref = np.asarray(jax_attention(jq, jk, jv, key_padding_mask=jm))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(axis=0), (T, H, D)),
                               atol=1e-5)
    pallas = np.asarray(fused_encoder_attention(jq, jk, jv, jm, float(D**-0.5),
                                                interpret=True))
    assert np.abs(pallas[0] - got[0]).max() > 1e-2  # the divergence
    np.testing.assert_allclose(pallas[1], got[1], atol=1e-5, rtol=1e-5)


def test_conv_tail_matches_jax_reference():
    """K2's plain version vs conv_tail_reference: 512 channels, T1 = 2100;
    1e-4 (six chained 512x1536 fp32 contractions)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(1, 2100, conv_tail.CH)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(k, conv_tail.CH, conv_tail.CH)) * (2.0 / (k * 512)) ** 0.5)
          .astype(np.float32) for k, _ in TAIL_SPEC]
    assert tuple(TAIL_SPEC) == conv_tail.TAIL_SPEC
    ref = np.asarray(conv_tail_reference(jnp.asarray(x), [jnp.asarray(w) for w in ws]))
    got = conv_tail.conv_tail(torch.from_numpy(x),
                              [torch.from_numpy(w.transpose(2, 1, 0).copy()) for w in ws])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def _port_mha_from_flax(tree, E, H):
    mha = MultiheadAttention(E, H, device="cpu")
    sd = {}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd[f"{proj}.weight"] = torch.tensor(np.asarray(tree[proj]["kernel"]).T.copy())
        sd[f"{proj}.bias"] = torch.tensor(np.asarray(tree[proj]["bias"]))
    mha.load_state_dict(sd)
    return mha


@pytest.mark.parametrize("cache_index", [0, 5, 11])
def test_decode_attention_matches_jax_crosscol(cache_index):
    """K3's plain version (through the port's MultiheadAttention.cached_step)
    vs the JAX crosscol lazy-reorder branch, on a random ancestry map; the
    output and the updated caches agree to 1e-5."""
    import jax

    rng = np.random.default_rng(cache_index)
    B, K, H, D, L = 2, 3, 2, 64, 12
    E, N = H * D, B * K
    jmha = JaxMHA(E, H)
    query = rng.normal(size=(N, 1, E)).astype(np.float32)
    kc = rng.normal(size=(L, H, D, N)).astype(np.float32)  # JAX layout [L, H, D, N]
    vc = rng.normal(size=(L, H, D, N)).astype(np.float32)
    anc = rng.integers(0, K, size=(L + 1, N)).astype(np.int32)
    params = jmha.init(jax.random.PRNGKey(0), jnp.asarray(query))
    out_j, cache_j = jmha.apply(
        params, jnp.asarray(query), cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_index=jnp.asarray(cache_index), cache_ancestry=jnp.asarray(anc[:L]),
        ancestry_groups=K,
    )
    mha = _port_mha_from_flax(params["params"], E, H)
    k_cache = torch.from_numpy(kc.transpose(3, 1, 0, 2).copy())  # port layout [N, H, L, D]
    v_cache = torch.from_numpy(vc.transpose(3, 1, 0, 2).copy())
    with torch.no_grad():
        out = mha.cached_step(torch.from_numpy(query), k_cache, v_cache,
                              torch.from_numpy(anc), cache_index, K)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    for got, ref in ((k_cache, cache_j["k"]), (v_cache, cache_j["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(3, 1, 0, 2),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "entry", ["encoder_attention", "conv_tail", "decode_attention", "logmel"])
def test_cuda_entry_refuses_cpu_tensors(entry):
    """A kernel's CUDA entry raises on a CPU tensor instead of falling back
    to the plain version, and its launch count stays where it was."""
    x = torch.zeros(1, 8, 1, 64)
    calls = {
        "encoder_attention": (encoder_attention.encoder_attention_cuda, (x, x, x)),
        "conv_tail": (conv_tail.conv_tail_cuda, (torch.zeros(1, 8, 512), [])),
        "decode_attention": (decode_attention.decode_attention_cuda,
                             (x[0], x[0], x[0], x, x, torch.zeros(2, 1, dtype=torch.int32),
                              0, 1)),
        "logmel": (logmel.logmel_cuda, (torch.zeros(2, 16000),)),
    }
    fn, args = calls[entry]
    wrapper = getattr(globals()[entry], entry)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        fn(*args)
    assert wrapper.launches == before
