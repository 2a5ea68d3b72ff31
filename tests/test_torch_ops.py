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


@pytest.mark.parametrize("D", [64, 96, 80])
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


def _edge_mask(B, T):
    """Row 1 padded from key 50 on (crossing the kernel's 64-key tile edges
    where T > 64) or from T // 2; no partly padded row is possible at T 1."""
    mask = np.zeros((B, T), bool)
    if T > 1:
        mask[1, min(50, T // 2):] = True
    return mask


@pytest.mark.parametrize("T", [1, 63, 65, 130])
def test_encoder_attention_tile_edges_match_jax(T):
    """K1's plain version vs JAX dot_product_attention and the Pallas kernel
    (interpret mode) at lengths around the bf16 kernel's 64-key / 64-query
    tiles, with padding that crosses a tile edge; 1e-5."""
    rng = np.random.default_rng(T)
    B, H, D = 2, 2, 96
    q, k, v = _qkv(rng, B, T, H, D)
    mask = _edge_mask(B, T)
    got = encoder_attention.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                              torch.from_numpy(mask)).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    np.testing.assert_allclose(got, np.asarray(jax_attention(jq, jk, jv, key_padding_mask=jm)),
                               atol=1e-5, rtol=1e-5)
    pallas = fused_encoder_attention(jq, jk, jv, jm, float(D**-0.5), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("T", [1, 63, 65, 130])
def test_encoder_attention_fully_padded_row_at_tile_edges(T):
    """A fully padded row beside a partly padded one, at the tile-edge
    lengths: the plain version follows the XLA path (V averaged over the T
    real keys); the Pallas kernel is the known divergence, not compared."""
    rng = np.random.default_rng(100 + T)
    B, H, D = 3, 2, 64
    q, k, v = _qkv(rng, B, T, H, D)
    mask = _edge_mask(B, T)
    mask[2, :] = True
    got = encoder_attention.encoder_attention(*map(torch.from_numpy, (q, k, v)),
                                              torch.from_numpy(mask)).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    np.testing.assert_allclose(got, np.asarray(jax_attention(jq, jk, jv, key_padding_mask=jm)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(axis=0), (T, H, D)), atol=1e-5)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _k1_tiled_mirror(q, k, v, mask, round_p, head_dim=None):
    """numpy mirror of the bf16 K1 kernel's arithmetic (csrc/encoder_attention.cu):
    64-key tiles, online softmax in the log2 domain, a padded real key at
    -1e8 * log2(e), a key past T at -inf, P optionally rounded to bf16 before
    P.V, the row sum taken over the unrounded P. ``head_dim`` is the real
    head dim where the inputs carry zero columns past it (D 80 in 96)."""
    B, T, H, D = q.shape
    log2e = np.float32(1.4426950408889634)
    scale = np.float32((head_dim or D)**-0.5) * log2e
    out = np.zeros_like(q)
    for b in range(B):
        for h in range(H):
            m = np.full(T, -np.inf, np.float32)
            l = np.zeros(T, np.float32)
            o = np.zeros((T, D), np.float32)
            for k0 in range(0, T, 64):
                keys = np.arange(k0, k0 + 64)
                real = keys < T
                kt = np.zeros((64, D), np.float32)
                vt = np.zeros((64, D), np.float32)
                kt[real], vt[real] = k[b, keys[real], h], v[b, keys[real], h]
                s = (q[b, :, h] @ kt.T) * scale
                padded = np.zeros(64, bool)
                padded[real] = mask[b, keys[real]]
                s[:, padded] = np.float32(-1e8) * log2e
                s[:, ~real] = -np.inf
                m_new = np.maximum(m, s.max(axis=1))
                alpha = np.exp2(m - m_new)
                p = np.exp2(s - m_new[:, None])
                l = l * alpha + p.sum(axis=1)
                o = o * alpha[:, None] + (_bf16(p) if round_p else p) @ vt
                m = m_new
            out[b, :, h] = o / l[:, None]
    return out


@pytest.mark.parametrize("round_p, tol", [(False, 1e-5), (True, 2e-2)])
@pytest.mark.parametrize("T", [1, 65, 130])
def test_encoder_attention_tiled_mirror_matches_plain(T, round_p, tol):
    """The bf16 kernel's tile-by-tile online softmax, mirrored in numpy, vs
    the plain version: with fp32 P it agrees to 1e-5, which checks the
    -1e8 / -inf split across tiles (a fully padded row, padding across a tile
    edge, the ragged last tile); with bf16 P it stays inside the card's 2e-2
    tolerance."""
    rng = np.random.default_rng(200 + T)
    B, H, D = 3, 2, 64
    q, k, v = (_bf16(x) for x in _qkv(rng, B, T, H, D))
    mask = _edge_mask(B, T)
    mask[2, :] = True
    ref = encoder_attention.encoder_attention_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)).numpy()
    got = _k1_tiled_mirror(q, k, v, mask, round_p)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("T", [65, 130])
def test_encoder_attention_tiled_mirror_at_head_dim_80(T):
    """The bf16 kernel at D 80 keeps three 32-column slabs: columns 80-95 of
    Q, K and V read as zeros (TMA's fill past the tensor map's extent), and
    P.V runs 96 wide. The mirror over the zero-padded inputs, cut back to 80
    columns, vs the plain version at D 80: 1e-5 with fp32 P, 2e-2 with bf16
    P; the padded columns of the output stay 0."""
    rng = np.random.default_rng(300 + T)
    B, H, D = 2, 2, 80
    q, k, v = (_bf16(x) for x in _qkv(rng, B, T, H, D))
    mask = _edge_mask(B, T)
    ref = encoder_attention.encoder_attention_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(mask)).numpy()
    q96, k96, v96 = (np.concatenate([x, np.zeros((B, T, H, 16), np.float32)], axis=-1)
                     for x in (q, k, v))
    for round_p, tol in ((False, 1e-5), (True, 2e-2)):
        got = _k1_tiled_mirror(q96, k96, v96, mask, round_p, head_dim=D)
        np.testing.assert_array_equal(got[..., D:], 0.0)
        np.testing.assert_allclose(got[..., :D], ref, atol=tol, rtol=0)
    assert D in encoder_attention.HEAD_DIMS


def _conv_inputs(rng, B, T1):
    x = (rng.normal(size=(B, T1, conv_tail.CH)) * 0.5).astype(np.float32)
    ws = [(rng.normal(size=(k, conv_tail.CH, conv_tail.CH)) * (2.0 / (k * 512)) ** 0.5)
          .astype(np.float32) for k, _ in TAIL_SPEC]
    return x, ws


@pytest.mark.parametrize("T1", [79, 300])
def test_conv_tail_short_inputs_match_jax_reference(T1):
    """K2's plain version vs conv_tail_reference at batch 2: T1 = 79 is the
    shortest input the six layers take (one output frame), 300 leaves a
    ragged last tile in every layer; 1e-4."""
    rng = np.random.default_rng(T1)
    x, ws = _conv_inputs(rng, 2, T1)
    ref = np.asarray(conv_tail_reference(jnp.asarray(x), [jnp.asarray(w) for w in ws]))
    got = conv_tail.conv_tail(torch.from_numpy(x),
                              [torch.from_numpy(w.transpose(2, 1, 0).copy()) for w in ws])
    assert got.shape == ref.shape == (2, 1 if T1 == 79 else 4, conv_tail.CH)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(RuntimeError):
        conv_tail.conv_tail(torch.from_numpy(x[:, :78]),
                            [torch.from_numpy(w.transpose(2, 1, 0).copy()) for w in ws])


def _k2_tiled_mirror(x, w_torch):
    """numpy mirror of one layer of the bf16 K2 kernel's addressing
    (csrc/conv_tail.cu): per batch row, 128-frame M tiles; depth tile kt
    reads tap kt // (C / 64) through a map based at x + tap * C with row
    stride 2C, rows past T_out read as zeros; weights as [C_out, k * C_in]."""
    B, t_in, C = x.shape
    k = w_torch.shape[2]
    t_out = (t_in - k) // 2 + 1
    wk = w_torch.transpose(0, 2, 1).reshape(C, k * C)  # [co, j * C + ci]
    flat = x.reshape(-1)
    out = np.zeros((B, t_out, C), np.float32)
    for b in range(B):
        for t0 in range(0, t_out, 128):
            acc = np.zeros((128, C), np.float32)
            for kt in range(k * C // 64):
                tap, c0 = kt // (C // 64), (kt % (C // 64)) * 64
                a = np.zeros((128, 64), np.float32)
                for r in range(128):
                    t = t0 + r
                    if t < t_out:
                        start = b * t_in * C + t * 2 * C + tap * C + c0
                        a[r] = flat[start:start + 64]
                acc += a @ wk[:, kt * 64:(kt + 1) * 64].T
            rows = min(128, t_out - t0)
            out[b, t0:t0 + rows] = acc[:rows]
    return out


@pytest.mark.parametrize("T1", [79, 300])
def test_conv_tail_tiled_mirror_matches_plain(T1):
    """The bf16 K2 kernel's tap-by-tap implicit-GEMM addressing, mirrored in
    numpy on each layer, vs the plain version; 1e-4."""
    rng = np.random.default_rng(300 + T1)
    x, ws = _conv_inputs(rng, 2, T1)
    ws_torch = [w.transpose(2, 1, 0).copy() for w in ws]  # [C_out, C_in, k]
    ref = conv_tail.conv_tail(torch.from_numpy(x), list(map(torch.from_numpy, ws_torch))).numpy()
    y = x
    for w in ws_torch:
        y = torch.nn.functional.gelu(torch.from_numpy(_k2_tiled_mirror(y, w))).numpy()
    np.testing.assert_allclose(y, ref, atol=1e-4, rtol=1e-4)


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


def _k3_split_mirror(q, k_new, v_new, k_cache, v_cache, anc, step, beam, tile=64, gpw=4):
    """numpy mirror of the K3 kernel's arithmetic (csrc/decode_attention.cu),
    one (column, head) at a time: the column's new rows go into the cache;
    time tiles of `tile` rows, the time-`step` row taken from k_new / v_new
    of anc[step]'s column and never from the cache; rows past `step` never
    touched; warp w of 4 takes rows (4 i + w) * gpw + g of a tile (gpw row
    groups a warp: 4 with 8 lanes a row, 8 with 4) and keeps its own online
    softmax in the log2 domain; the four partial (max, sum, accumulator) are
    merged at the end. Updates the caches in place."""
    N, H, D = q.shape
    log2e = np.float32(1.4426950408889634)
    scale = np.float32(D**-0.5) * log2e
    k_before, v_before = k_cache.copy(), v_cache.copy()  # no block reads another's write
    k_cache[:, :, step], v_cache[:, :, step] = k_new, v_new
    out = np.zeros_like(q)
    for col in range(N):
        first_col = col // beam * beam
        for h in range(H):
            m = np.full(4, -np.inf, np.float32)
            l = np.zeros(4, np.float32)
            acc = np.zeros((4, D), np.float32)
            for t0 in range(0, step + 1, tile):
                for w in range(4):
                    rows = [(4 * i + w) * gpw + g for i in range(tile // (4 * gpw))
                            for g in range(gpw)]
                    ts = [t0 + r for r in rows if t0 + r <= step]
                    if not ts:
                        continue
                    src = [first_col + anc[t, col] for t in ts]
                    ks = np.stack([k_new[c, h] if t == step else k_before[c, h, t]
                                   for c, t in zip(src, ts)])
                    vs = np.stack([v_new[c, h] if t == step else v_before[c, h, t]
                                   for c, t in zip(src, ts)])
                    s = (ks @ q[col, h]) * scale
                    m_new = max(m[w], s.max())
                    alpha = np.exp2(m[w] - m_new)
                    p = np.exp2(s - m_new)
                    l[w] = l[w] * alpha + p.sum()
                    acc[w] = acc[w] * alpha + p @ vs
                    m[w] = m_new
            wgt = np.exp2(m - m.max())
            out[col, h] = (wgt @ acc) / (wgt @ l)
    return out


def _k3_inputs(rng, S, beam, H, L, D=64):
    N = S * beam
    q, k_new, v_new = (rng.normal(size=(N, H, D)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.normal(size=(N, H, L, D)).astype(np.float32) for _ in range(2))
    anc = rng.integers(0, beam, size=(L + 1, N)).astype(np.int32)  # anc[step] not the identity
    return q, k_new, v_new, kc, vc, anc


@pytest.mark.parametrize("step, L, tile", [(0, 64, 64), (31, 64, 64), (32, 64, 64), (63, 64, 64),
                                           (150, 200, 64), (40, 64, 32)])
def test_decode_attention_split_mirror_matches_plain(step, L, tile):
    """The K3 kernel's warp-split, tile-by-tile online softmax, mirrored in
    numpy, vs the plain version: output within 1e-5 and the caches equal
    exactly, with a random anc[step]. Cache rows past `step` are NaN: they
    must never enter a product. Steps 0, 31, 32, 63 (warp-split edges of one
    64-row tile), step 150 in a 200-long cache (three tiles) and the fp32
    kernel's 32-row tile."""
    rng = np.random.default_rng(400 + step)
    q, k_new, v_new, kc, vc, anc = _k3_inputs(rng, 2, 3, 2, L)
    kc[:, :, step + 1:], vc[:, :, step + 1:] = np.nan, np.nan
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ref = decode_attention.decode_attention_plain(
        *map(torch.from_numpy, (q, k_new, v_new)), kc_t, vc_t, torch.from_numpy(anc), step, 3)
    got = _k3_split_mirror(q, k_new, v_new, kc, vc, anc, step, 3, tile)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(kc, kc_t.numpy())
    np.testing.assert_array_equal(vc, vc_t.numpy())


def _k3_split(D, itemsize):
    """(times per tile, row groups per warp) of the kernel's K3Split<T, D>:
    a row is D * itemsize / 16 chunks, read by 8 lanes when they divide it,
    else by 4, else by 2; a tile is the largest power of two of rows within
    512 chunks, or one pass of the 4 warps' row groups where that is more."""
    ch = D * itemsize // 16
    lpr = 8 if ch % 8 == 0 else 4 if ch % 4 == 0 else 2
    return max(1 << (512 // ch).bit_length() - 1, 4 * (32 // lpr)), 32 // lpr


@pytest.mark.parametrize("D, itemsize, step, L", [
    (96, 2, 0, 64), (96, 2, 31, 64), (96, 2, 63, 64), (96, 4, 40, 64),
    (32, 2, 63, 64), (32, 2, 150, 200), (32, 4, 63, 64)])
def test_decode_attention_split_mirror_at_head_dims_96_and_32(D, itemsize, step, L):
    """The K3 split of D 96 (12 chunks a bf16 row, 4 lanes of 3 chunks,
    32-row tiles; 24 fp32 chunks, 8 lanes of 3, 16-row tiles) and of D 32
    (4 chunks a bf16 row, 4 lanes of 1, 128-row tiles; fp32 as D 64 bf16),
    mirrored in numpy, vs the plain version: output within 1e-5, caches
    equal, NaN past the step never read."""
    tile, gpw = _k3_split(D, itemsize)
    assert (tile, gpw) == {(96, 2): (32, 8), (96, 4): (16, 4), (32, 2): (128, 8),
                           (32, 4): (64, 4)}[D, itemsize]
    rng = np.random.default_rng(600 + step + D)
    q, k_new, v_new, kc, vc, anc = _k3_inputs(rng, 2, 3, 2, L, D)
    kc[:, :, step + 1:], vc[:, :, step + 1:] = np.nan, np.nan
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ref = decode_attention.decode_attention_plain(
        *map(torch.from_numpy, (q, k_new, v_new)), kc_t, vc_t, torch.from_numpy(anc), step, 3)
    got = _k3_split_mirror(q, k_new, v_new, kc, vc, anc, step, 3, tile, gpw)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(kc, kc_t.numpy())
    np.testing.assert_array_equal(vc, vc_t.numpy())


@pytest.mark.parametrize("itemsize, step, L", [(2, 0, 64), (2, 63, 64), (2, 150, 200),
                                                (4, 31, 64), (4, 40, 64)])
def test_decode_attention_split_mirror_at_head_dim_80(itemsize, step, L):
    """The K3 split of D 80 (the xlm preset's 1,280 / 16 heads): 10 chunks a
    bf16 row, 2 lanes of 5 chunks, so 16 row groups a warp and a 64-row
    tile (one pass of the warps, 640 chunks); 20 fp32 chunks, 4 lanes of 5,
    a 32-row tile. Mirrored in numpy vs the plain version: output within
    1e-5, caches equal, NaN past the step never read."""
    tile, gpw = _k3_split(80, itemsize)
    assert (tile, gpw) == {2: (64, 16), 4: (32, 8)}[itemsize]
    rng = np.random.default_rng(800 + step + itemsize)
    q, k_new, v_new, kc, vc, anc = _k3_inputs(rng, 2, 3, 2, L, 80)
    kc[:, :, step + 1:], vc[:, :, step + 1:] = np.nan, np.nan
    kc_t, vc_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ref = decode_attention.decode_attention_plain(
        *map(torch.from_numpy, (q, k_new, v_new)), kc_t, vc_t, torch.from_numpy(anc), step, 3)
    got = _k3_split_mirror(q, k_new, v_new, kc, vc, anc, step, 3, tile, gpw)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(kc, kc_t.numpy())
    np.testing.assert_array_equal(vc, vc_t.numpy())
    assert 80 in decode_attention.HEAD_DIMS


@pytest.mark.parametrize("D", [96, 32, 80])
@pytest.mark.parametrize("anc_seed", [0, 1])
@pytest.mark.parametrize("step", [0, 5, 11])
def test_decode_attention_plain_at_head_dims_96_and_32_matches_pallas(D, anc_seed, step):
    """decode_attention (the plain version on the CPU) at the head dims of
    the megatron (96) and gbw (32) LM presets vs the Pallas kernel in
    interpret mode, at two random ancestries and three steps; the caches
    hold this step's rows afterwards."""
    from chimera_st_tpu.ops.pallas_decode_attention import decode_step_attention

    rng = np.random.default_rng(700 + D + step)
    B, C, H, L = 2, 3, 2, 12
    N = B * C
    q, k_new, v_new = (rng.normal(size=(N, H, D)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.normal(size=(N, H, L, D)).astype(np.float32) for _ in range(2))
    anc = np.random.default_rng(anc_seed).integers(0, C, size=(L + 1, N)).astype(np.int32)
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = decode_attention.decode_attention(
        *map(torch.from_numpy, (q, k_new, v_new)), k_cache, v_cache, torch.from_numpy(anc),
        step, C).numpy()
    kc[:, :, step], vc[:, :, step] = k_new, v_new
    np.testing.assert_array_equal(k_cache.numpy(), kc)
    np.testing.assert_array_equal(v_cache.numpy(), vc)

    def pallas_layout(c):  # [N, H, L, D] -> [B, H, C*L, D], row c*L + l
        return jnp.asarray(c.reshape(B, C, H, L, D).transpose(0, 2, 1, 3, 4)
                           .reshape(B, H, C * L, D))

    want = decode_step_attention(jnp.asarray(q.reshape(B, C, H, D)), pallas_layout(kc),
                                 pallas_layout(vc), jnp.asarray(anc[:L]), jnp.asarray(step),
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(want).reshape(N, H, D), atol=1e-5, rtol=1e-5)
    assert D in decode_attention.HEAD_DIMS


@pytest.mark.parametrize("cache_index, tile", [(0, 64), (31, 64), (32, 64), (63, 64), (40, 32)])
def test_decode_attention_split_mirror_matches_jax_crosscol(cache_index, tile, monkeypatch):
    """The mirrored K3 arithmetic, put in the place of the kernel inside the
    port's MultiheadAttention.cached_step, vs the JAX crosscol lazy-reorder
    branch on a random ancestry map; output and caches within 1e-5."""
    import jax

    from chimera_st_tpu_torch.models import layers

    def mirrored(q, k_new, v_new, k_cache, v_cache, ancestry, index, beam):
        kc, vc = k_cache.numpy(), v_cache.numpy()  # views: updated in place
        return torch.from_numpy(_k3_split_mirror(q.numpy(), k_new.numpy(), v_new.numpy(), kc, vc,
                                                 ancestry.numpy(), index, beam, tile))

    monkeypatch.setattr(layers, "decode_attention", mirrored)
    rng = np.random.default_rng(500 + cache_index)
    B, K, H, D, L = 2, 3, 2, 64, 64
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
