"""Hub-style API over a checkpoint (counterpart of chimera_st_tpu/hub.py;
fairseq ``hub_utils.py`` ``from_pretrained`` and
``GeneratorHubInterface``):

    import chimera_st_tpu_torch.hub as hub
    m = hub.from_pretrained("ckpt/checkpoint_best.ckpt", data_dir="bin",
                            source_lang="de", target_lang="en")
    m.translate(["Hallo Welt"])                  # -> ["hello world"]
    m.sample(["Hallo Welt"], sampling_topk=10)   # sampling

text -> tokenizer -> BPE -> dictionary -> the task's ``SequenceGenerator``
on the model's device (each decoder step's self-attention through K3 on
the card, a bidirectional encoder's layers through K1) -> text. The
RoBERTa hub is ``models/roberta_hub.py``; this is its sequence-to-sequence
counterpart over any registered text task and model.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def from_pretrained(
    checkpoint_path: str,
    data_dir: Optional[str] = None,
    task: str = "translation",
    bpe: Optional[str] = None,
    bpe_cfg: Optional[Dict] = None,
    tokenizer: Optional[str] = None,
    dtype: str = "float32",
    device: str = "cuda",
    **overrides: Any,
) -> "GeneratorHubInterface":
    """A native ``.ckpt`` and its task's dictionaries behind the interface;
    ``overrides`` reach the task and the model config."""
    from .cli.generate import load_model_and_params, torch_dtype
    from .tasks import setup_task

    t = setup_task({"_name": task, "data": data_dir, **overrides})
    model = load_model_and_params(checkpoint_path, t, torch_dtype(dtype), device,
                                  dict(overrides))
    return GeneratorHubInterface(t, model, bpe=bpe, bpe_cfg=bpe_cfg, tokenizer=tokenizer)


class GeneratorHubInterface:
    """tokenize -> bpe -> dictionary -> beam decode -> detokenize."""

    def __init__(self, task, model, bpe=None, bpe_cfg=None, tokenizer=None):
        from .data.encoders import build_bpe, build_tokenizer

        self.task = task
        self.model = model
        self.src_dict = task.source_dictionary or task.target_dictionary
        self.tgt_dict = task.target_dictionary
        self.bpe = build_bpe(bpe_cfg if bpe_cfg else ({"_name": bpe} if bpe else None))
        self.tokenizer = build_tokenizer({"_name": tokenizer} if tokenizer else None)
        self._generators: Dict[tuple, Any] = {}

    @property
    def device(self):
        return next(self.model.parameters()).device

    # ------------------------------------------------------------- text I/O

    def encode(self, sentence: str):
        """str -> int32 token ids (+ eos), through the tokenizer and BPE."""
        import numpy as np

        if self.tokenizer is not None:
            sentence = self.tokenizer.encode(sentence)
        if self.bpe is not None:
            sentence = self.bpe.encode(sentence)
        return np.asarray(self.src_dict.encode_line(sentence, append_eos=True), np.int32)

    def decode(self, token_ids) -> str:
        s = self.tgt_dict.string(token_ids, bpe_symbol=None if self.bpe is None else "@@ ")
        if self.bpe is not None and hasattr(self.bpe, "decode"):
            s = self.bpe.decode(s)
        if self.tokenizer is not None:
            s = self.tokenizer.decode(s)
        return s

    # ------------------------------------------------------------ translate

    def translate(self, sentences: List[str], beam: int = 5, **gen_kwargs) -> List[str]:
        return [h[0]["text"] for h in self.generate(sentences, beam=beam, **gen_kwargs)]

    def sample(self, sentences: List[str], sampling_topk: int = -1,
               sampling_topp: float = -1.0, **kw) -> List[str]:
        return [h[0]["text"] for h in self.generate(
            sentences, sampling=True, sampling_topk=sampling_topk,
            sampling_topp=sampling_topp, **kw)]

    def fill_mask(self, masked_input: str, topk: int = 5, mask_token: str = "<mask>",
                  match_source_len: bool = True, **gen_kwargs):
        """BART's denoising infill of ``<mask>`` spans: the spans around the
        mask BPE-encoded, a beam decode with beam >= topk, [(text, score)]
        best first; ``match_source_len`` pins the hypothesis length to the
        source's."""
        if mask_token not in masked_input:
            raise ValueError(f"input needs one {mask_token}")
        if match_source_len:
            gen_kwargs.setdefault("max_len_a", 1.0)
            gen_kwargs.setdefault("max_len_b", 0)
            gen_kwargs.setdefault("min_len_a", 1.0)
            gen_kwargs.setdefault("min_len_b", -1)
        import numpy as np

        spans = masked_input.split(mask_token)
        spans = [self.bpe.encode(s.strip()) if self.bpe is not None else s.strip()
                 for s in spans]
        joined = f" {mask_token} ".join(spans).strip()
        ids = np.asarray(self.src_dict.encode_line(joined, append_eos=True), np.int32)
        gen_kwargs["beam"] = max(topk, gen_kwargs.get("beam", 1))
        hyps = self.generate_tokens([ids], nbest=topk, **gen_kwargs)[0]
        return [(h["text"], h["score"]) for h in hyps]

    def generate(self, sentences: List[str], **gen_kwargs) -> List[List[Dict]]:
        """-> each sentence's n-best [{'text', 'tokens', 'score'}]."""
        return self.generate_tokens([self.encode(s) for s in sentences], **gen_kwargs)

    def generate_tokens(self, encoded, beam: int = 5, nbest: int = 1,
                        **gen_kwargs) -> List[List[Dict]]:
        import numpy as np
        import torch

        from .data.batching import collate_tokens
        from .generation.generator import SequenceGenerator

        key = (beam, tuple(sorted(gen_kwargs.items())))
        if key not in self._generators:
            cfg = type("GenCfg", (), {"beam": beam, **gen_kwargs})
            self._generators[key] = self.task.build_generator(self.model, cfg)
        gen = self._generators[key]
        src = torch.as_tensor(collate_tokens(encoded, self.src_dict.pad(), dtype=np.int32),
                              dtype=torch.long, device=self.device)
        lengths = torch.as_tensor([len(e) for e in encoded], dtype=torch.long,
                                  device=self.device)
        batches = SequenceGenerator.to_hypotheses(*gen.generate_text(src, src_lengths=lengths),
                                                  nbest=nbest)
        for hyps in batches:
            for h in hyps:
                h["text"] = self.decode(h["tokens"])
        return batches
