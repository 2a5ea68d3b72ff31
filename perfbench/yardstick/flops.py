"""Model operations that the inputs need, for ``mfu``: 2 a multiply-add of
every matrix product and convolution, at the unpadded lengths of each
utterance (so a change that cuts padding shows), attention over the keys
that each query may see (causal: the earlier steps). Elementwise work,
norms and softmaxes are left out. Training counts forward plus backward as
3 times the forward, without recomputation.

Sizes come from a configuration file's ``model`` table (the port's field
names); ``kind`` is its ``reference`` (``chimera`` or ``s2t``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple


def conv_lengths(n: int, spec: Sequence[Sequence[int]]):
    """Frame counts after each (dim, kernel, stride) layer of the extractor."""
    out = []
    for _, k, s in spec:
        n = (n - k) // s + 1
        out.append(n)
    return out


def subsampled(n: int, layers: int) -> int:
    for _ in range(layers):
        n = (n - 1) // 2 + 1
    return n


def encoder_stack(T: int, D: int, F: int, layers: int) -> float:
    """Self-attention layers over T positions: Q, K, V, O projections, QK^T
    and PV, the feed-forward."""
    return layers * (8.0 * T * D * D + 4.0 * T * T * D + 4.0 * T * D * F)


def interlingua(M: int, T: int, D: int, F: int, layers: int) -> float:
    """The memory slots' cross-only layers: M queries over T keys."""
    return layers * (4.0 * M * D * D + 4.0 * T * D * D + 4.0 * M * T * D + 4.0 * M * D * F)


def decoder_teacher(U: int, mem: int, D: int, F: int, V: int, layers: int) -> float:
    """The decoder over U target positions (teacher-forced) with a memory of
    ``mem`` states, and the output projection."""
    per_layer = (8.0 * U * D * D + 2.0 * D * U * (U + 1)  # self-attention, causal
                 + 4.0 * U * D * D + 4.0 * mem * D * D + 4.0 * U * mem * D  # cross
                 + 4.0 * U * D * F)
    return layers * per_layer + 2.0 * U * D * V


def decoder_beam(steps: int, rows: int, mem: int, D: int, F: int, V: int, layers: int) -> float:
    """``rows`` hypotheses decoded for ``steps`` steps through the cache:
    at step i each row's new position attends to i + 1 cached ones; the
    cross-attention keys and values are projected once a sentence."""
    attend = 2.0 * D * steps * (steps + 1)  # sum over i of 4 (i + 1) D
    per_row = layers * (steps * (8.0 * D * D + 4.0 * D * D + 4.0 * mem * D + 4.0 * D * F)
                        + attend) + steps * 2.0 * D * V
    return rows * per_row + layers * 4.0 * mem * D * D


def chimera_audio(n: int, m: Dict) -> Tuple[float, int]:
    """The interlingua model's audio encoder for n samples -> (operations,
    memory slots)."""
    spec = m["w2v2_conv_spec"]
    lens = conv_lengths(n, spec)
    flops, cin = 0.0, 1
    for (dim, k, _), t in zip(spec, lens):
        flops += 2.0 * t * k * cin * dim
        cin = dim
    T, E = lens[-1], m["w2v2_embed_dim"]
    flops += 2.0 * T * cin * E  # post_extract_proj
    flops += 2.0 * T * m["w2v2_conv_pos"] * E * (E // m["w2v2_conv_pos_groups"])
    flops += encoder_stack(T, E, m["w2v2_ffn_dim"], m["w2v2_layers"])
    ks, ch, D = m["conv_kernel_sizes"], m["conv_channels"], m["encoder_embed_dim"]
    t, cin = T, E
    for i, k in enumerate(ks):
        t = (t - 1) // 2 + 1
        cout = ch if i < len(ks) - 1 else 2 * D
        flops += 2.0 * t * k * cin * cout
        cin = cout // 2
    flops += encoder_stack(t, D, m["encoder_ffn_dim"], m["encoder_layers"])
    M = m["interlingua_length"]
    flops += interlingua(M, t, D, m["encoder_ffn_dim"], m["interlingua_layers"])
    return flops, M


def chimera_text(S: int, m: Dict) -> float:
    D, F = m["encoder_embed_dim"], m["encoder_ffn_dim"]
    return (encoder_stack(S, D, F, m["encoder_layers"])
            + interlingua(m["interlingua_length"], S, D, F, m["interlingua_layers"]))


def s2t_audio(n: int, m: Dict) -> Tuple[float, int]:
    """The fbank model's encoder for n samples -> (operations, encoder
    states): the log-mel's framing and FFT, the subsampler, the stack."""
    frames = max(1 + (n - 400) // 160, 0)
    flops = frames * (5 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * 257 + 80)
    ks, ch, D = m["conv_kernel_sizes"], m["conv_channels"], m["encoder_embed_dim"]
    t, cin = frames, m["input_feat_per_channel"]
    for i, k in enumerate(ks):
        t = (t - 1) // 2 + 1
        cout = ch if i < len(ks) - 1 else 2 * D
        flops += 2.0 * t * k * cin * cout
        cin = cout // 2
    flops += encoder_stack(t, D, m["encoder_ffn_dim"], m["encoder_layers"])
    return flops, t


def audio_encoder(kind: str, n: int, m: Dict) -> Tuple[float, int]:
    return chimera_audio(n, m) if kind == "chimera" else s2t_audio(n, m)


def decoder_sizes(m: Dict):
    return (m["decoder_embed_dim"], m["decoder_ffn_dim"], m["tgt_vocab_size"],
            m["decoder_layers"])


def train_utterance(kind: str, n: int, S: int, U: int, m: Dict) -> float:
    """One triplet training example (audio pass and text pass), forward and
    backward."""
    D, F, V, L = decoder_sizes(m)
    audio, mem = audio_encoder(kind, n, m)
    forward = audio + decoder_teacher(U, mem, D, F, V, L)
    if kind == "chimera":
        forward += chimera_text(S, m) + decoder_teacher(U, m["interlingua_length"], D, F, V, L)
    return 3.0 * forward


def translate_utterance(kind: str, n: int, steps: int, beam: int, m: Dict) -> float:
    """One utterance encoded and decoded by ``beam`` hypotheses for
    ``steps`` steps."""
    D, F, V, L = decoder_sizes(m)
    audio, mem = audio_encoder(kind, n, m)
    return audio + decoder_beam(steps, beam, mem, D, F, V, L)
