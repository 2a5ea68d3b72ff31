"""PyTorch/CUDA port of chimera_st_tpu for NVIDIA Hopper (H100).

Two speech-translation serving paths under the lazy-reorder beam search:

- the flagship ``s2t_transformer_w2v2_interlingua``: raw 16 kHz audio ->
  wav2vec2 trunk -> Conv1d subsampler -> shared encoder -> interlingua
  memory -> transformer decoder (``models/interlingua.py``);
- the fbank ``s2t_transformer`` presets: raw audio -> kaldi log-mel on the
  device (or 80-d features) -> Conv1d+GLU subsampler -> transformer encoder
  -> decoder (``models/s2t_transformer.py``).

The TPU package's Pallas kernels are hand-written CUDA kernels here
(``csrc/``), each with a plain PyTorch version beside it in ``ops/``.
Imports torch and numpy only.
"""
