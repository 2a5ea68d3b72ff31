"""The RoBERTa hub interface and the XLM-initialised translation model
(counterpart of chimera_st_tpu/models/roberta_hub.py; fairseq
``models/roberta/hub_interface.py``, ``roberta/alignment_utils.py`` and
``models/transformer_from_pretrained_xlm.py``).

``RobertaHubInterface`` is a host-side API over a ``MaskedLMModel``: text
to tokens through an optional BPE (any object with ``encode`` / ``decode``
over strings, e.g. ``data/encoders`` entries), features of the last layer,
mask filling, classification heads kept on the host, and the word
alignment of BPE features. Its encoder runs on the model's device, each
layer's self-attention through K1 there.

``init_transformer_from_pretrained_xlm`` copies a masked-LM (XLM)
checkpoint's embeddings and encoder layers into a ``TransformerModel``'s
state dict, matching the two through ``convert.py``'s tables (the names of
the JAX trees, where the JAX function matches them).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .masked_lm import MaskedLMModel


class RobertaHubInterface:
    """Host-side convenience API over a trained masked LM."""

    def __init__(self, model: MaskedLMModel, dictionary, bpe=None):
        self.model = model.eval()
        self.dictionary = dictionary
        self.bpe = bpe
        self._heads: Dict[str, Any] = {}

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.atleast_2d(np.asarray(tokens)), dtype=torch.long,
                               device=self.device)

    # --------------------------------------------------------------- tokens

    def encode(self, sentence: str) -> np.ndarray:
        """text -> <s> tokens </s> (through the BPE where one is given, else
        whitespace-split)."""
        text = self.bpe.encode(sentence) if self.bpe is not None else sentence
        ids = [self.dictionary.bos()]
        for tok in text.split():
            ids.append(self.dictionary.index(tok))
        ids.append(self.dictionary.eos())
        return np.asarray(ids, np.int32)

    def decode(self, tokens: np.ndarray) -> str:
        specials = (self.dictionary.bos(), self.dictionary.eos(), self.dictionary.pad())
        toks = [int(t) for t in np.asarray(tokens).tolist() if int(t) not in specials]
        text = " ".join(self.dictionary[t] for t in toks)
        return self.bpe.decode(text) if self.bpe is not None else text

    # ------------------------------------------------------------- features

    @torch.no_grad()
    def features(self, tokens) -> torch.Tensor:
        """Last-layer states [B, T, C] on the model's device, in its dtype."""
        return self.model.encode(self._tokens(tokens))[0]

    def extract_features(self, tokens: np.ndarray) -> np.ndarray:
        """[T] or [B, T] token ids -> fp32 features [B, T, C] on the host."""
        return self.features(tokens).float().cpu().numpy()

    @torch.no_grad()
    def fill_mask(self, tokens: np.ndarray, mask_position: int, topk: int = 5
                  ) -> List[Tuple[str, float]]:
        """Top-k fills of the token at ``mask_position`` (the first row)."""
        logits = self.model(self._tokens(tokens))[0, mask_position].cpu().numpy()
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        order = np.argsort(-probs)[:topk]
        return [(self.dictionary[int(i)], float(probs[i])) for i in order]

    # ----------------------------------------------------- classification

    def register_classification_head(self, name: str, num_classes: int, seed: int = 0):
        """A head over the first token's features (dense, tanh, output),
        its weights drawn on the host from ``np.random.default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        d = self.model.cfg.embed_dim
        scale = 1.0 / np.sqrt(d)
        self._heads[name] = {
            "dense": rng.normal(scale=scale, size=(d, d)).astype(np.float32),
            "dense_b": np.zeros(d, np.float32),
            "out": rng.normal(scale=scale, size=(d, num_classes)).astype(np.float32),
            "out_b": np.zeros(num_classes, np.float32),
        }

    def predict(self, head: str, tokens: np.ndarray) -> np.ndarray:
        """log-probs [B, num_classes] from the first token's features."""
        h = self._heads[head]
        feats = self.extract_features(tokens)[:, 0]
        x = np.tanh(feats @ h["dense"] + h["dense_b"])
        logits = x @ h["out"] + h["out_b"]
        logits = logits - logits.max(-1, keepdims=True)
        return logits - np.log(np.exp(logits).sum(-1, keepdims=True))

    # ------------------------------------------------------ word alignment

    def _token_strings(self, bpe_tokens: np.ndarray) -> List[str]:
        """Each position's surface string; bos, eos and pad map to ''."""
        special = {self.dictionary.bos(), self.dictionary.eos(), self.dictionary.pad()}
        out = []
        for t in np.asarray(bpe_tokens).reshape(-1).tolist():
            t = int(t)
            if t in special:
                out.append("")
                continue
            s = self.dictionary[t]
            if self.bpe is not None:
                s = self.bpe.decode(s)
            out.append(s.strip())
        return out

    def align_bpe_to_words(self, bpe_tokens: np.ndarray,
                           other_tokens: List[str]) -> List[List[int]]:
        """Greedy alignment of words to BPE positions: the character streams
        must match; a word maps to one or more positions, and a position may
        span several words."""
        bpe_tokens = np.asarray(bpe_tokens).reshape(-1)
        assert int(bpe_tokens[0]) == self.dictionary.bos()
        bpe_strs = self._token_strings(bpe_tokens)[1:]  # past the leading <s>
        other = [str(o).strip() for o in other_tokens]
        if "".join(bpe_strs) != "".join(other):
            raise ValueError(f"cannot align {other!r} to BPE stream {bpe_strs!r}")
        alignment: List[List[int]] = []
        nonempty = iter([(j, s) for j, s in enumerate(bpe_strs, start=1) if s != ""])
        j, bpe_tok = next(nonempty)
        for other_tok in other:
            bpe_indices: List[int] = []
            while True:
                if other_tok.startswith(bpe_tok):
                    bpe_indices.append(j)
                    other_tok = other_tok[len(bpe_tok):]
                    try:
                        j, bpe_tok = next(nonempty)
                    except StopIteration:
                        j, bpe_tok = None, ""
                elif bpe_tok.startswith(other_tok):
                    # the word ends inside this BPE token
                    bpe_indices.append(j)
                    bpe_tok = bpe_tok[len(other_tok):]
                    other_tok = ""
                else:
                    raise ValueError(f'cannot align "{other_tok}" and "{bpe_tok}"')
                if other_tok == "":
                    break
            assert len(bpe_indices) > 0
            alignment.append(bpe_indices)
        assert len(alignment) == len(other)
        return alignment

    @staticmethod
    def align_features_to_words(features: np.ndarray,
                                alignment: List[List[int]]) -> np.ndarray:
        """BPE features pooled onto words, the total kept: a position shared
        by K words is split K ways; rows are [<s>, words..., unaligned
        tail]."""
        features = np.asarray(features)
        assert features.ndim == 2
        counts = np.ones(len(features), np.float32)
        flat = [j for idxs in alignment for j in idxs]
        assert 0 not in flat  # <s> is never aligned
        for j in set(flat):
            counts[j] = flat.count(j)
        weighted = features / counts[:, None]
        rows = [weighted[0]]
        largest = -1
        for idxs in alignment:
            rows.append(weighted[idxs].sum(axis=0))
            largest = max(largest, *idxs)
        for j in range(largest + 1, len(features)):
            rows.append(weighted[j])
        out = np.stack(rows)
        assert np.abs(out.sum(0) - features.sum(0)).max() < 1e-3
        return out

    def extract_features_aligned_to_words(self, sentence: str,
                                          words: Optional[List[str]] = None
                                          ) -> Tuple[List[str], np.ndarray]:
        """Word-aligned features of a sentence: ``words`` (by default its
        whitespace split) -> (['<s>'] + words + ['</s>'], features)."""
        if words is None:
            words = sentence.split()
        toks = self.encode(sentence)
        alignment = self.align_bpe_to_words(toks, words)
        feats = self.extract_features(toks)[0].astype(np.float32)
        aligned = self.align_features_to_words(feats, alignment)
        labels = ["<s>"] + list(words) + ["</s>"]
        assert len(labels) == len(aligned)
        return labels, aligned


# ------------------------------------------------- pretrained-XLM transformer


def init_transformer_from_pretrained_xlm(transformer_state: Mapping[str, torch.Tensor],
                                         xlm_state: Mapping[str, torch.Tensor],
                                         init_decoder: bool = False
                                         ) -> Dict[str, torch.Tensor]:
    """A copy of ``transformer_state`` (a ``TransformerModel``'s) with the
    masked-LM's ``embed_tokens`` and ``layers_i`` leaves written over the
    encoder's leaves of the same flax name and shape (and its
    ``embed_tokens`` over the decoder's too with ``init_decoder``); the
    other leaves keep their values. Raises if nothing matched."""
    from ..convert import torch_to_flax_path

    by_flax = {torch_to_flax_path("transformer", k)[0]: k for k in transformer_state}
    out = {k: v.clone() for k, v in transformer_state.items()}
    copied = 0
    for key, value in xlm_state.items():
        path, _ = torch_to_flax_path("masked_lm", key)
        if not (path[0] == "embed_tokens" or path[0].startswith("layers_")):
            continue
        targets = [path]
        if init_decoder and path[0] == "embed_tokens":
            targets.append(("decoder",) + path)
        for target in targets:
            dst = by_flax.get(target)
            if dst is not None and out[dst].shape == value.shape:
                out[dst] = value.detach().to(out[dst].dtype).clone()
                copied += 1
    if copied == 0:
        raise ValueError("no XLM parameters matched the transformer tree: incompatible "
                         "dims or naming")
    return out


def build_transformer_from_pretrained_xlm(cfg_dict: Dict, device="cuda"):
    """The ``transformer`` model; the XLM weights come in through the
    task's ``post_init_params``."""
    from .transformer_mt import build_transformer

    return build_transformer(cfg_dict, device=device)


MODEL_BUILDERS = {"transformer_from_pretrained_xlm": build_transformer_from_pretrained_xlm}
ARCHITECTURES = {"transformer_from_pretrained_xlm": ("transformer_from_pretrained_xlm", dict)}
