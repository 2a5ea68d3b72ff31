#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (chimera_st_tpu_torch) on one card.

Run from the root of a checkout:  python3 chip_smoke.py

It drives both ported serving paths: the flagship interlingua model (raw
wav -> wav2vec2 trunk -> ... -> beam 10) and the fbank speech-to-text
transformer ``s2t_transformer_s`` with ``compute_fbank`` (raw wav -> log-mel
-> subsampler -> encoder -> beam 5); then the training recipe, and the
fairseq Transformer family (MT serving, an LM fused into the decode, LM
perplexity), Chimera's joint MT + ST training, every optimizer and schedule
of the train CLI, the adaptive-softmax and character-input LMs, and the
non-autoregressive family (CMLM, vanilla / iterative NAT, NAT-CRF,
Levenshtein, insertion), served and trained, BART / mBART with the
multilingual transformer, served and trained, the wav2vec family:
speech recognition (CTC and seq2seq) served and fine-tuned, wav2vec 2.0
pre-training and Chimera's bimodal variant, and the masked-LM family:
RoBERTa served through its hub and pre-trained, BERT's legacy objective,
XLM's cross-lingual one and the XLM-initialised translation model, the
xlm preset at head dim 80, and the convolutional and recurrent zoo
(fconv, lightconv / dynamicconv, the LSTMs, s2t_berard, the benchmark and
tutorial tasks), the untied output projection, GPT-2, the stacked pipeline
LM, quantization and a world of one over NCCL, and the host layer of the ST
fine-tune (the training wire format, the waveform cache, the C++ batch
packer and edit distance).

Phases (any failure raises and the script exits non-zero):

1. device  - a CUDA card must be present; prints nvidia-smi's name and
             power limit.
2. build   - compiles the four hand-written kernels (csrc/*.cu, one nvcc
             per source, in parallel, linked into one library) and prints
             the build seconds and, for K3 and K4, the compiler's registers,
             spill bytes and shared memory; then reads the library's SASS
             (cuobjdump, which must be there): the bf16 K1 and K2 kernels
             must hold tensor-core instructions (HGMMA, from wgmma), K3 the
             asynchronous copy (LDGSTS, from cp.async), K4 fp64 DFMA and no
             local-memory access (LDL / STL).
3. kernels - holds each kernel against its plain PyTorch version, batch 8
             unless stated: K1 (encoder attention) at the flagship shapes,
             at the fbank encoder's (4 heads), at a 30 s trunk (batch 2,
             T 1,499), at T 65 and at the trunk shape of a released
             checkpoint (12 heads of 64, T 299) and at head dim 128 (B 32,
             T 64 / 128, 4 heads: transformer_iwslt_de_en's MT batches);
             K2 (conv tail) on 6 s and, at batch 3,
             1.5 s inputs; K3 (beam-step decode attention) at beam 10 /
             8 heads and beam 5 / 4 heads, each at steps 0, 31 and 63 of a
             64-long cache and, with 2 sentences, at step 150 of a 200-long
             one, and at head dim 128 (32 sentences x beam 5, 4 heads, and x
             beam 4, 8 heads: the wiki103 LM's; beside each SDPA over the
             gathered rows), k3_wide: at head dims 96 (32
             heads: the megatron LM presets) and 32 (16 heads: the gbw
             ones), 32 sentences x beam 4, steps 0, 31 and 63, the ancestry row of the step
             drawn at random, cache rows
             past the step NaN, the cache after the call bit-equal to the
             plain version's; K4 (log-mel) on 6 s rows, a 33,000-sample row
             (204 frames) and rows of 99 frames at unaligned addresses. bf16
             kernels vs the plain version in fp32 on the same (bf16-valued)
             inputs, fp32 kernels vs fp32 plain (K4 also vs the plain
             version in fp64). Prints each max abs error with its tolerance,
             and the median times of the kernel, the plain version and, where
             one PyTorch call computes the same function, that call; the
             share of the bound; for K1 and K2 the achieved TFLOP/s; for K3
             and K4 the time of an empty kernel (launch_floor_ms), for K3 the
             measured time of 64 launches, one at each step 0..63
             (steps_0_63_ms), and the host time of one call (host_us). With
             --parent DIR (a `git archive` of an earlier commit) the script
             runs these K3 and K4 cases once more in a process whose package
             is that tree's, and puts its times beside the new ones
             (parent_ms, parent_steps_0_63_ms).
4. parity  - each serving path at full width in fp32 (TF32 off), batch 2:
             generate_audio on the card (through the kernels) and on the CPU
             (through the plain versions) with the same weights; the best
             hypotheses must be token-identical.
5. serve   - each path's operating point with seeded random weights, bf16,
             3 batches of 8 utterances of 2-6 s with padding after one
             warm-up batch. Flagship: vocab 10000, beam 10, max_decode_len 64,
             len_penalty 1.5, min_len 30. Fbank: vocab 8000, beam 5,
             max_decode_len 64. Launch counts are zeroed just before each
             path's timed batches and read just after; every kernel of the
             path must have launched, and no other. The counts are exact:
             per batch K1 24 (flagship) or 12 (fbank), K2 6, K4 1, K3 384
             (6 decoder layers x 64 steps).
5a. w2v2_st - the plain w2v2 + Transformer ST model without a memory bank
             (s2t_transformer_w2v2_s from the registries: 12 x 768 trunk at 12
             heads of 64, 12 x 256 shared encoder at 4 heads, 6-layer
             decoder; vocabularies of 10,000), as the flagship: fp32 card vs
             CPU token-identical, then 3 bf16 batches of 8 with exact
             launches a batch (K1 24, K2 6, K3 384); its batch under
             torch.profiler was cut for the time limit (its busy share: the
             earlier runs in PERF.md). In the CLI phases
             (w2v2_st_cli) the same weights as a native .ckpt in the JAX
             trainer's layout go through cli.generate in bf16 on the 24
             wavs (K1 24 and K2 6 a batch, K3 6 a decoder step).
5b. search - the flagship's generation surface on one seeded batch of 2
             utterances of 2-6 s, beam 10, max_decode_len 64 (a second model
             from another seed for the ensemble): plain beam, diverse groups
             (2, strength 0.5), diverse siblings (rate 0.5), ordered and
             unordered lexical constraints (two seeded phrases a sentence),
             the two-model ensemble, LM shallow fusion (lm_fusion: a
             transformer_lm of transformer_lm_gpt's widths, 768 wide, GELU,
             4 of its 12 layers, over the 10,000-word vocabulary, weight
             0.3), reference
             scoring, alignments (the last
             layer's cross-attention over the best hypotheses), the int8 KV
             cache, sampling at top-k 1 and retained dropout. Each mode but
             the last in fp32 on the card (kernels) and on the CPU (plain
             versions) from the same weights and encoder inputs, 32
             decoder steps (cut from 64 for the time limit): best
             hypotheses token-identical, best scores within 1e-4 (reference
             scores 1e-4 the mean, 1e-3 each token; alignment weights 1e-4
             and their argmax), constrained hypotheses hold their phrases,
             top-k 1 is the CPU model's greedy decode; every K3 launch at
             steps 5, 15 and 31 is held against the plain version on
             clones of its inputs at the ancestry the mode built (1e-4, the
             rows written bit-equal; sampling's ancestry must stay the
             identity). Then each mode in bf16 on the card between CUDA
             events, one run of each (retained dropout two),
             counts zeroed before and exact after each run (a batch: K1 24,
             K2 6, K3 6 a decoder step, 6 + 12 with the LM; the ensemble and
             the alignment pass encode twice; int8 and reference scoring
             launch no K3; retained
             dropout no K1); retained dropout gives the same tokens in every
             round with one seed, and not plain beam search's; then K3 in
             bf16 at each mode's step-63 ancestry held against the fp32 plain
             version (2e-2, the rows written bit-equal) and timed, its bytes
             bound counting the cache rows that ancestry references before
             the step. Prints {"search": {...}}.
6. cli     - the entry points a user starts, on a fixture made from a seed
             under a temporary directory with the port's own code: 24 wavs of
             2-6 s, a manifest, 10,000-entry dictionaries, config_wave.yaml
             (as JSON) and a fairseq-layout .pt of the flagship model
             (weight-normed pos_conv, pretraining heads, args with the nested
             w2v_args of a released checkpoint: 12 trunk heads).
             checkpoint: the .pt read back through the CLI's loader equals
             the seeded model. cli_parity: cli.generate on the card and with
             --device cpu in fp32 (8 decode steps, PARITY_DECODE, as every
             CLI parity run of the family and BART phases; served: 64):
             every sample has its S-/H-/D-/P- lines,
             best hypotheses identical as strings, scores within 1e-4 (plus
             the two roundings to the four printed decimals), the same corpus
             BLEU line. cli_serve: the same command in bf16, launch counts
             zeroed before and read after: K1 24 and K2 6 a batch, K3 6 a
             decode step that ran; prints {"cli": {...}} (sentences, wall_s,
             sentences_per_s, load_s, data_s = reading and collating the
             batches alone, launches). interactive: 4 wav paths
             from a file, 2 a buffer, against cli.generate on the same wavs
             in batches of 2. text: generate_text on the card against the
             CPU, fp32, token-identical (K1 at text shapes, K3; K3 exactly 6
             a decode step that ran). cli_shapes: every shape and dtype at
             which these phases launched K1 and K2 is noted as they run (each
             padded batch's trunk, shared-encoder and conv-tail shapes, the
             text batch's T 32), and K1 and K2 are then held against their
             plain versions at each of them, in bf16 and in fp32, with the
             tolerances of phase 3.
7. train   - the triplet fine-tune step, on the same fixture (its 24 wavs
             as train_wave.tsv). train_kernels: K1 (trunk at 12 heads of 64
             and 8 of 96, shared encoder) and K2 (B 8, 6 s) through their
             autograd Functions (kernel forward, plain recomputed backward),
             bf16 and fp32, every gradient against autograd through the
             plain version in fp32 (tolerances over each gradient's max),
             and the backward's time. train_parity: the recipe's model at
             full width, fp32, TF32 off, every dropout 0, a batch of 2: loss,
             gnorm and every parameter's gradient on the card (kernels) vs
             the CPU (plain versions), then the parameters after one Adam
             update. train: the recipe's operating point (interlingua length
             64, 12 trunk heads, dropouts at their defaults, label smoothing
             0.1, loss ratio 1 1 1, Adam (0.9, 0.98), inverse-sqrt lr 1e-4,
             warm-up cut to 4 updates), bf16 autocast over fp32 parameters,
             3 micro-batches of 8 an update: one warm-up update and 3 timed,
             launch counts exact (K2 6 a micro-batch; K1 0, as attention
             dropout takes the plain path), step 4, a NaN batch changes no
             parameter, Adam state or step, and one more update with both
             attention dropouts 0 launches K1 36 times a micro-batch (12
             trunk, 12 shared encoder on audio, 12 on text). Prints
             {"train": {...}} (updates/s, audio s/s, target tokens/s, peak
             memory, forward / backward ms of a micro-batch, launches; with
             --profile the device's busy share of one update). train_kernels
             also times SDPA forward + backward beside K1's backward.
             train_cli: the train CLI in-process with the recipe's flags
             (recipes/train-en2any-ST.sh) and a seeded fairseq-layout
             wav2vec2 .pt of the base trunk, warm-up 4, micro-batches of 8,
             3 an update, bf16: run A from a fresh start to 2 updates, run
             B resumed from A's checkpoint_last to 3, then cli.generate of
             B's checkpoint_best (beam 10, bf16). Exact launches (a
             training micro-batch K2 6, K1 0; a validation batch, eval
             mode, K1 36, K2 6; the decode K1 24 and K2 6 a batch, K3 6 a
             step); A's checkpoint_last: its optimizer tree read back
             equals the trainer's Adam state bit for bit, and the file
             restored by load_state into the trainer, zeroed first, gives
             back its parameters and Adam state; B starts at step 2 at
             the stored iterator position and ends at step 4 with the
             iterator and best metric of the JAX rules; the decode prints
             one hypothesis per utterance. Prints {"train_cli": {...}}
             (updates/s after the first update beside train's, seconds a
             save, the file's size, the resume's load seconds, validation
             seconds, peak memory, launches) and deletes its files.
8. mt      - the MT pre-training stage (recipes/train-en2any-MT.sh) on
             seeded parallel text (880 training pairs of 4-120 Zipf-drawn
             subwords, targets within +-20 % of their source's length, 128
             valid and 128 test pairs) with a joined dictionary of 40,000,
             binarized by the port's preprocess CLI. mt_parity: the base
             preset in fp32, every dropout 0, one update of 2 micro-batches
             of 8 pairs on the card (K1 through its Function) and on the
             CPU from the same weights: loss, gnorm, every trained gradient
             and the Adam update within train_parity's gates; the audio
             trunk masked out of Adam (bit-identical to its start on both
             devices, no Adam state), the optimizer tree of the JAX
             trainer's masked layout. mt_cli: the train CLI in-process with
             the recipe's flags (interlingua length 64, label smoothing
             0.1, Adam (0.9, 0.98), inverse_sqrt lr 5e-4, --max-tokens 4096
             --update-freq 8) and the cut --warmup-updates 4, bf16: run A
             to epoch 2, run B resumed to epoch 3, the averaging tool over
             the three epoch files, then cli.generate --task translation of
             the averaged file (beam 5, max decode length 64, batches of
             32, bf16). Exact launches (a training micro-batch none; a
             validation batch K1 12; the decode K1 12 a batch and K3 6 a
             decoder step); written = held and the resume's state as in
             train_cli; prints {"mt_cli": {...}} (updates and source /
             target tokens a second after the first update, over run A's
             second epoch, seconds a save, the
             file's size beside the unmasked tree's, the resume's load
             seconds, validation seconds, the averaging's seconds, the
             decode's sentences a second, peak memory, launches; with
             --profile one update under torch.profiler). mt_shapes: K1
             against its plain version at every shape the MT phases
             launched, bf16 and fp32, and K3 at every shape of the decode
             as phase 3 holds it (steps 0, 31, 63; bf16 and fp32; cache
             writes bit-equal).
             fbank_features (run with the CLI phases): the s2t_transformer_s
             preset (vocabulary 8000, seeded native .ckpt) served by
             cli.generate --task speech_to_text, beam 5, on 16 seeded
             utterances of 200-600 80-d frames (8 .npy, 8 zip-packed), the
             config naming utterance_cmvn for '*' and specaugment +
             utterance_cmvn for _train; fp32 card vs --device cpu identical,
             then bf16 with exact launches (K1 12 a batch, K3 6 a decoder
             step, K2 and K4 0). Prints {"fbank_features": {...}}.
9. family  - the fairseq Transformer family on seeded text over one joined
             dictionary of 32,768 subwords (binarized by the port's
             preprocess: 64 test and 4 parity pairs of 4-120 Zipf-drawn
             subwords; a 100,000-token monolingual stream), each model
             seeded and written as a native .ckpt by the port's writer in
             the JAX layout. mt_big: transformer_wmt_en_de_big (6 + 6 x 1024,
             FFN 4096, 16 heads of 64, post-norm, ReLU; separate source and
             target embeddings) through cli.generate --task translation
             --beam 4 --lenpen 0.6 --max-decode-len 64 (fairseq's WMT'16
             en-de big evaluation): fp32 card vs --device cpu identical on
             one batch of 2, then bf16 on one batch of 32 with exact launches
             (K1 6 a batch, K3 6 a decoder step, K2 and K4 0); prints
             {"mt_big": {...}} (sentences/s, load_s, peak memory).
             lm_fusion: the same with --lm-path of a transformer_lm saved
             with transformer_lm_gpt's widths stated (768, FFN 3072, 12
             heads, GELU; 4 of its 12 layers) and --lm-weight 0.3 (K3 6 + 4
             a step).
             eval_lm: cli.eval_lm of that LM on the stream,
             --tokens-per-sample 512, context windows 0 and 256: fp32 card
             vs CPU within 1e-5 bits/token over the first 8 blocks, then
             the whole stream in bf16 (tokens/s), no kernel launched (the
             forward is causal). iwslt: transformer_iwslt_de_en (6 + 6 x
             512, 4 heads of 128) served as mt_big, K1 and K3 at head dim
             128. lm_fusion_gbw / lm_fusion_megatron: iwslt with
             --lm-path of a transformer_lm_gbw LM at full width (512, 16
             heads of 32) with 4 of its 12 layers and of a
             transformer_lm_megatron LM at full width (3072, 32 heads of
             96) with 2 of its 72 layers, as lm_fusion (K3 6 + 4 and 6 + 2
             a step, at head dims 32 and 96). mt_big then runs one more
             batch under the CLI's --profile and reads the device's busy
             share from its trace (the other serve phases' profiled
             batches are cut for the time limit). family_shapes (after mt_shapes): K1 and K3 against
             their plain versions at every shape these phases launched, as
             mt_shapes.
10. family training - family_train: cli.train --task translation --arch
             transformer (512 / 2048 / 8 heads, 6 + 6 layers, attention
             dropout 0) on 1,600 more seeded pairs of the family text,
             fairseq's WMT'16 recipe (label smoothing 0.1, Adam (0.9,
             0.98), inverse_sqrt lr 5e-4, --max-tokens 4096) with the
             warm-up cut to 4, bf16, BLEU validation as the checkpoint
             metric (scored by sacrebleu, or where it is not installed by
             a stand-in module of the same formula): run A to update 10,
             run B resumed to 12 under --profile; then cli.validate of the
             checkpoint without --arch, cli.generate from it, and one
             accumulated step at full width in fp32 on the card and on the
             CPU (mt_parity's gates). Exact launches: K1 6 a training
             micro-batch, 6 a validation batch and 6 a BLEU decode batch,
             K3 6 a decoder step. Prints {"family_train": {...}} (updates
             and tokens a second after run A's first update, from each
             update's seconds: validations and saves excluded; peak
             memory, busy share, seconds a save,
             the checkpoint's size, the resume's load seconds). lm_train:
             cli.train --task language_modeling --arch transformer_lm_gpt
             --criterion lm_cross_entropy on the stream, 512-token blocks,
             8 a micro-batch, 10 updates, bf16, then cli.eval_lm on the
             result and the fp32 step parity; no kernel launched (causal).
             Prints {"lm_train": {...}}. slice_shapes: every K1, K2 and K3
             shape that w2v2_st (its parity and serving), w2v2_st_cli,
             tts_update and family_train launched, held against the plain
             versions as the other shape phases hold them (bf16 and fp32,
             K3 at the first, middle and last step of its cache with the
             cache writes bit-equal), accuracy only; the phase demands the
             trunk (H 12), the shared encoder (H 4) and the family (H 8) in
             K1, beams 10 / H 4 and 4 / H 8 in K3, and K2.
7a. joint  - joint_train (run after tts_update, on the CLI fixture): Chimera's
             joint MT + ST fine-tune through cli.train --task joint_task_mtst
             --task-configs (JSON: the 24 wavs as the ST sub-task's train and
             valid splits, 48 seeded MT pairs over the same dictionaries at
             sample ratio 0.5 and weight 0.5) --main-task st, the flagship at
             full width with train_cli's recipe flags, bf16, micro-batches of
             8, 2 an update: run A to 6 updates, run B resumed to 8 (its
             --profile cut for the time limit), each validating the ST
             sub-task and saving at its end; cli.generate --task triplet of the checkpoint; one fp32
             update of an ST and an MT micro-batch card vs CPU (train_parity's
             gates). Exact launches: K2 6 on each ST micro-batch and 0 on an
             MT one, K1 0 in training, 36 (and K2 6) a validation batch; the
             decode K1 24 / K2 6 a batch, K3 6 a step. Prints
             {"joint_train": {...}} (updates/s, audio s/s and target tokens/s
             after run A's first update, peak memory).
10a. optimizers and the adaptive LM - optim_sweep: cli.train --arch
             transformer (1 + 1 layers) on family_train's data for each of the eight
             optimizers and, under adam, each of the five other schedules
             (6 updates, warm-up 2; clip 0.1 but for adafactor;
             reduce_lr_on_plateau validating every 2 updates): the written
             optax tree restores into a fresh optimizer equal to the
             trainer's, one fp32 update card vs CPU (loss, gnorm, every
             gradient; Adam's bound, or each tensor's update within 1e-2 in
             L2), K1 2 a micro-batch; prints {"optim_sweep": {...}}.
             lm_adaptive: transformer_lm_wiki103 at full width (1024, 4 of
             its 16 layers, adaptive softmax 20,000 / 60,000) with adaptive_loss over a
             seeded 267,744-word dictionary, 3072-token blocks, nag + cosine
             (the wiki103 recipe, warm-up and period cut), bf16, 5 updates,
             eval_lm, an fp32 step on one 512-token block; one update of
             transformer_lm_gbw --character-embeddings; no kernel launched;
             prints {"lm_adaptive": {...}}. lm_fusion_adaptive (in the family
             phases): iwslt with --lm-path of a full-width wiki103 LM (4
             of its 16 layers) over the family's 32,768-subword dictionary
             (cutoffs 8,000 / 20,000), served as lm_fusion (K3 6 + 4 a step
             at D 64 / 128).
             joint_shapes (timed) and optim_shapes (accuracy only): every K1,
             K2 and K3 shape these phases launched against the plain
             versions.
11. the non-autoregressive family (this slice's main path, on the
             family's fixture) - nat_serve: a seeded .ckpt of each of the
             six models at the presets' full width (512 / 2048 / 8 heads,
             6 + 6 layers: levenshtein_transformer_wmt_en_de with
             --iter-decode-max-iter 9 --iter-decode-eos-penalty 0
             --print-step, cmlm_transformer_wmt_en_de with
             --iter-decode-max-iter 10 --iter-decode-with-beam 5, the
             vanilla and iterative NAT, nacrf_transformer,
             insertion_transformer under translation_ins), then a
             two-checkpoint Levenshtein ensemble, CMLM with
             --iter-decode-with-external-reranker (a transformer as the
             last --path) and Levenshtein with --retain-iter-history, each
             through
             cli.generate on canvases of 64: fp32 card vs CPU on the 4
             valid sentences (hypotheses and step counts identical; a
             difference prints the sentence and its top-2 margin), then
             bf16 on the 32 test pairs in one batch, K1 exact (6 encoder
             layers a batch and member, 6 for each decoder pass that ran:
             Levenshtein 3 a round, its rounds checked against the printed
             steps, insertion 1 a round, CMLM 10, the others 1; the
             reranker's encoder 6), no K3; the transformer at the same
             width on the same batches at beam 4 and 1 beside them. Prints
             {"nat_serve": {...}} (sentences/s). nat_train: cli.train --task
             translation_lev --noise levenshtein --criterion
             levenshtein_loss --arch levenshtein_transformer_wmt_en_de on
             family_train's pairs, fairseq's recipe flags (label smoothing
             0.1, Adam (0.9, 0.98), inverse_sqrt lr 5e-4, dropout 0.3,
             --max-tokens 8000) with the warm-up cut to 4, bf16: run A to 10
             updates, run B resumed to 12 under --profile, cli.generate of
             its checkpoint; one update each of CMLM, the vanilla NAT, NAT-CRF
             and insertion; one fp32 update of each criterion card vs CPU
             (compare_step). K1 exact: 6 + 18 a Levenshtein micro-batch, 6 +
             6 the others'. Prints {"nat_train": {...}} (updates/s after the
             first, target tokens/s, peak memory, run B's busy share, the
             host seconds a batch spends in the noising and the edit
             operations as data_s). nat_shapes (after the other shape
             groups): K1 at every shape nat_serve launched (timed, with
             SDPA) and nat_train launched (accuracy), and at 16 heads of 64
             (levenshtein_transformer_vaswani_wmt_en_de_big) on the canvas.
12. BART / mBART and the multilingual transformer (this slice's main
             path, on a fixture of its own: mBART.cc25's 250,027-row table,
             bart.large's 50,265, a 10,000-subword IWSLT-like de / fr / en
             dictionary) - bart_serve: a seeded .ckpt of mbart_large at
             full width and depth (12 + 12 layers of 1,024, 16 heads of 64)
             served by cli.generate --task translation_from_pretrained_bart
             -s en_XX -t ro_RO --langs <the 25 cc25 languages> at batch 32,
             beam 5, --max-decode-len 64: fp32 card vs CPU on the 2 valid
             pairs (hypotheses and decoder steps identical), then bf16 on 32
             test pairs (sentences/s, load_s, peak memory; K1 12 a batch, K3
             12 a decoder step, exact); bart_large under --task translation
             at beam 4 beside it. Prints {"bart_serve": {...}}. bart_train:
             cli.train, bf16, of the mBART fine-tune (fairseq's
             examples/mbart flags, from the served checkpoint with
             --restore-file and the --reset-* flags), denoising on bart_base
             (the BART paper's noise; run A to 3 updates, run B resumed to
             5), RTE on bart_large (examples/bart/README.glue.md), the
             multilingual transformer (examples/translation, de-en and
             fr-en, --share-decoders) and translation_multi_simple_epoch on
             a transformer (then cli.generate of its checkpoint), each with
             a validation at the stop, fairseq's warm-up cut to 2 updates
             (4 for the multilingual run); K1 exact (the encoder's layers a
             training micro-batch where attention dropout is 0, a
             validation batch always); one fp32 update of each card vs CPU
             (compare_step; the BART models at 2 + 2 layers, widths and
             vocabularies kept). Prints {"bart_train": {...}} (updates/s
             after the first, peak memory, the resume's load seconds).
             bart_shapes (after nat_shapes): K1 and K3 at every shape they
             launched against the plain versions; the served batches' and
             each head width's largest batch timed, K1 with SDPA beside it.
13. the wav2vec family (this slice's main path, on a fixture of its
             own: 24 seeded wavs of 2-16 s with letter transcripts and
             fairseq's 32-entry dict.ltr.txt, a seeded 3-gram ARPA LM over
             the letters, 10 wavs of 16-20 s and as many aligned pairs) -
             the fixture writes a fairseq-layout Wav2VecCtc .pt at wav2vec
             2.0 base width (12 x 768, 12 heads of 64, the default conv
             spec, mask_emb) and reads it back through the ported importer
             (every tensor equal) into a native .ckpt. asr_serve:
             cli.generate --task audio_pretraining --labels ltr of it: fp32
             card vs CPU on the 2 shortest wavs, greedy and prefix beam 50
             fused with the LM (--ctc-lm-path, weight 0.5), hypotheses
             identical; bf16 greedy on the 24 wavs at --max-tokens 1280000
             (K1 12 and K2 6 a batch, exact; utt/s, audio s/s, load_s, the
             busy share of a run under --profile), beam 50 + LM on the 2
             wavs. asr_seq2seq: wav2vec_seq2seq (decoder 10 x 1,024, 16
             heads) at beam 5: fp32 card vs CPU at PARITY_DECODE steps,
             then bf16 on the 24 wavs, 64 steps (K3 10 a decoder step).
             asr_train: cli.train with fairseq's README base fine-tune
             flags (--apply-mask --mask-prob 0.5 --layerdrop 0.1
             --feature-grad-mult 0.0, tri_stage with its phases cut to one
             epoch, --max-tokens 1280000, --best-checkpoint-metric wer), one
             WER validation and one save, then cli.generate of
             checkpoint_best (K1 one a trunk layer that ran, LayerDrop's
             choice; K2 6 a forward of the extractor), one profiled update
             (the plain K1 backward's share of its device time), one fp32
             update card vs CPU at 2 layers (widths kept, the mask given).
             w2v_pretrain: cli.train --task audio_pretraining --arch
             wav2vec2 at base width with 12 heads (fairseq's pre-training
             flags: crops of 250,000 samples, 5 a batch, 100 negatives,
             mask 0.65, 320 x 2 codes, final dim 256), one epoch and a
             validation (K2 forward and backward in every micro-batch, K1
             only in validation: attention dropout 0.1), one fp32 update
             card vs CPU at 2 layers with the Gumbel noise given.
             bimodal_pretrain: --task bimodal_pretraining --arch
             wav2vec2_quasiwave with wav2vec_bimodal and with
             aligning_loss_bimodal (two streams: K2 12 a micro-batch), one
             update of the k-means quantizer, one of wav2vec v1 (TrainStep;
             no kernel). w2v_shapes (after bart_shapes): K1, K2 and K3 at
             every shape the phases launched; timed: K1 at the
             pre-training crop (B 5, T 781, with SDPA) and the largest, K2
             forward and backward at the crop with cuDNN beside them, K3 at
             the seq2seq decode's largest served shape.
14. mlm    - the masked-LM family on a fixture made from a seed (a GPT-2
             BPE of 50,257 symbols, fairseq RoBERTa's 50,260-line dict.txt
             of its ids: 50,265 rows with the specials and <mask>; 96 + 16
             sentences of 30-240 tokens; en / fr folders; de-en pairs on the
             same dictionary). mlm_serve: roberta_large (24 x 1,024, 16
             heads of 64) from a native .ckpt through the RoBERTa hub in
             bf16: extract_features over 3 batches of 16 rows of 64-512
             tokens (K1 24 a batch), fill_mask on 4 BPE-encoded sentences,
             predict through a 3-class head (K1 24 a call), the counts
             exact; a profiled batch (busy share); cli.validate --task
             masked_lm (K1 24 a batch); first the hub fp32 card vs CPU at 2
             of 24 layers (features 1e-3, fill_mask's top 5 identical,
             predict 1e-4). mlm_train: cli.train --task masked_lm --arch
             roberta_base with fairseq's README flags (--update-freq and the
             warm-up cut), run A one epoch with its validation and save, run
             B resumed; one fp32 update card vs CPU at 2 of 12 layers; two
             updates each of legacy_masked_lm (bert_base, next-sentence
             head), cross_lingual_lm (xlm_base), translation_from_pretrained_xlm
             from that XLM checkpoint, then one cli.generate batch of it
             (beam 5, K1 6, K3 6 a decoder step), and
             semisupervised_translation (K1 only in validation: attention
             dropout 0.1). mlm_shapes (after w2v_shapes): K1 and K3 at
             every shape these launched; timed: K1 at the hub's B 16 / T
             512 / H 16 / D 64 (with SDPA), K3 at the XLM decode's.
15. xlm and the zoo - xlm_serve: the xlm preset (16 x 1,280, 16 heads of
             80) through the hub in bf16 (K1 at D 80, 16 a batch of 16 x
             64-512 tokens), then a transformer_from_pretrained_xlm model at
             its widths (2 + 2 layers) initialised from that checkpoint and
             decoded by one cli.generate batch (K1 at D 80 in the encoder,
             K3 at H 16 / D 80 in every step), the counts exact; first the
             hub fp32 card vs CPU at 2 of 16 layers. xlm_shapes: K1 and K3
             at D 80 at every shape it launched, bf16 and fp32, K3 at steps
             0 / 31 / 63 with the caches bit-equal; timed: K1 at B 16 / T
             512 / H 16 / D 80 (with SDPA), K3 at the decode's. zoo_lm_train:
             cli.train --task language_modeling of fconv_lm_dauphin_wikitext103,
             lightconv_lm_gbw, dynamicconv_lm and lstm_lm on the family's
             LM stream, 2 updates each, lstm_lm resumed for one more and
             validated by cli.validate. zoo_steps: one bf16 TrainStep update
             at full width of fconv_wmt_en_de, fconv_self_att,
             lightconv_wmt_en_de_big, dynamicconv_iwslt_de_en and
             lstm_luong_wmt_en_de on a family MT batch, of s2t_berard_512_5_3
             on seeded wavs through compute_fbank (K4 once an update, first
             held against its plain version on that batch) and of
             dummy_model on a dummy_lm batch, each with its ms an update,
             peak memory and, where it has recurrences, the ms of
             restacking their gate layers; then one fp32 update of
             lstm_luong at 1 + 1 layers card vs CPU. zoo_tasks: cli.train of
             dummy_mt (transformer), dummy_lm (transformer_lm),
             dummy_masked_lm (roberta_base) and simple_classification
             (rnn_classifier), 3 updates each. The zoo's launch counts are
             exact: none but K1 in dummy_mt's encoder and K4 in berard's.
             zoo_shapes (after xlm_shapes): K1 at every shape the zoo
             launched, bf16 and fp32.
16. untied, gpt2, pipe_lm, quant; dist1 - untied: the CLI fixture's
             flagship with an output projection of its own as a fairseq .pt
             (share_decoder_input_output_embed False in its args):
             cli.generate fp32 card vs CPU on 4 wavs (identical), then bf16
             with the counts exact (K2, K1, K3); an untied
             s2t_transformer_s through compute_fbank (K4 held on its batch,
             fp32 card vs CPU beam 5 identical, bf16 counts exact: K4, K1,
             K3). gpt2: hf_gpt2 at full width and depth, 2 bf16 updates
             through cli.train --task language_modeling on the family's LM
             stream at 1,024 tokens a sample; hf_gpt2_xl at full width and
             depth, one bf16 TrainStep update of 2 x 1,024 tokens and its
             peak memory; an HF-named xl state dict at 2 layers, fp32 card
             vs CPU. pipe_lm: a transformer_lm checkpoint stacked into
             transformer_lm_pipe (logits on the card equal to the plain
             LM's), 2 bf16 updates through cli.train, unstacked and scored
             by eval_lm. quant: scalar fake quantization of the flagship's
             state dict bit-equal card vs CPU; PQ on the card, two matrices
             against the CPU from the same initial centroids. dist1 (inside
             train_cli): a world of one over NCCL, cli.train with
             --zero-sharding os at run A's settings, (loss, gnorm) equal to
             run A's, and a sharded cli.generate equal to one process: the
             wiring and NCCL on the card, not several ranks' numbers. No
             kernel in gpt2, pipe_lm or quant (causal attention is the
             plain path, as in JAX). a12_shapes (last of the shape
             groups): K1-K3 at every shape untied, dist1 and host_layer
             launched.
    host_layer (inside train_cli, after dist1) - the training wire
             format and the waveform cache: cli.train at run A's settings
             (validation and saves off) with the default wire (PCM16 as
             int16, no padding mask) and with --no-host-wire, a fresh
             cache each: (loss, gnorm) of both (the first loss bit-equal to
             run A's), each epoch's data_s and cache hits (epoch 2 from the
             cache), K2 6 a micro-batch; a micro-batch's audio and mask
             bytes and copy ms each way; the C++ batch packer and edit
             distance against their Python loops on 250,000 sizes and
             10,000 word pairs (the same results; the seconds of each).
17. report - one JSON line {"kernels": [...]} ("launches" sums the driven
             paths: both serve runs, w2v2_st, every search mode, cli_serve,
             text, fbank_features, both train runs, train_cli's training and
             decode, tts_update, mt_cli's and the family's, joint_train's,
             optim_sweep's, nat_serve's, nat_train's, bart_serve's,
             bart_train's, the wav2vec phases', the masked-LM
             phases', the xlm and zoo phases' and those of phase 16 and
             host_layer; K3's record holds its times at the search modes'
             ancestries, "search_ancestries";
             "launches_per_path" splits them), then the contract line
             {"ok": true, "device": {...}} as the last line of stdout.

With --kernels-of DIR the script only builds the package of the tree under
DIR and runs phase 3's K3 and K4 cases on it (what --parent starts).

With --profile, each serve phase (w2v2_st's too) ends with one more served batch under
torch.profiler (after the launch counts are read): the device's busy share
and the device time by kernel; cli_serve runs its command once more with
the CLI's --profile; train and mt_cli profile one more update. The busy
share has one definition throughout (trace_busy): the union of the
device's kernel, copy and set intervals in the profiler's trace over the
span from its first event to its last.

Longer logs (the compiler's register/shared-memory report, the profiles) go
to chiprun_out/, and so does a copy of the whole standard output
(chiprun_out/chip_smoke.log).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# fp32 and fp64 on the CUDA cores (not the tensor cores)
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12
# timed batches of each serve phase, after one warm-up batch
SERVE_BATCHES = 3
# the decode length of the CLI phases' fp32 card-vs-CPU parity runs (cut from
# their served 64 for the script's time limit: the CPU side is the cost)
PARITY_DECODE = ["--max-decode-len", "8"]  # 64 -> 24 -> 16 -> 8


def log(msg: str) -> None:
    print(msg, flush=True)


def host_probe(work: Path) -> dict:
    """Seconds of a fixed host workload, so that two runs of the script on
    different machines can be told apart by their host: a pure-Python loop
    of 10^7 additions (one core), twenty 1,024 x 1,024 fp32 numpy matmuls
    and 512 MB written to a file under ``work`` (the page cache, as the
    checkpoint saves write)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(10_000_000):
        x += i
    python_s = time.perf_counter() - t0
    a = np.random.default_rng(0).random((1024, 1024), dtype=np.float32)
    t0 = time.perf_counter()
    for _ in range(20):
        a @ a
    matmul_s = time.perf_counter() - t0
    block = np.ones(64 << 20, dtype=np.uint8)
    path = work / "host_probe.bin"
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(8):
            f.write(block.data)
    write_s = time.perf_counter() - t0
    path.unlink()
    out = dict(python_loop_s=python_s, numpy_matmul_s=matmul_s, write_512mb_s=write_s)
    log(f"host_probe: python loop {python_s:.3f} s, numpy matmuls {matmul_s:.3f} s, "
        f"512 MB written {write_s:.3f} s")
    return out


class Tee:
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()

    def __getattr__(self, name):  # isatty, fileno, encoding: the first stream's
        return getattr(self.streams[0], name)


def cuda_ms(fn, reps: int = 20, groups: int = 3) -> float:
    """Device time of one fn() call in ms: the median over `groups` of the
    mean of `reps` back-to-back calls between two CUDA events. Each group is
    queued behind a ~25 ms device-side sleep, so the host has enqueued every
    call before the first starts and the events time the device alone, not
    the host's launch rate (which exceeds a small kernel's run time)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # clock cycles: ~25 ms, more than the host takes to enqueue a group
        # (the slowest, 6 x 64 K3 launches or 20 plain-version calls, ~13 ms)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, peak_flops: float = BF16_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max abs error {err} exceeds {tol}")


class Inputs:
    """Seeded tensors on the card: normal draws of a CUDA generator (drawing
    them on the host took seconds a shape at the conv tail's sizes)."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def __call__(self, shape, scale=1.0, dtype=None):
        torch = self.torch
        t = torch.randn(shape, generator=self.gen, device="cuda") * scale
        return t.to(dtype or torch.bfloat16)


def rate_fields(flops: float, ms: float, b_ms: float) -> dict:
    """Achieved TFLOP/s and the share of the bound a kernel time reaches."""
    return dict(tflops=flops / ms / 1e9, bound_share=b_ms / ms)


def k1_case(torch, enc_attn, tensor, label, B, T, H, D, timed=True):
    """K1 at one shape: accuracy (bf16 and fp32); unless not ``timed``,
    times and bound. Row 1, where B > 1, is padded from T // 2 on (across a
    64-key tile edge), row 2, where B > 2, entirely (uniform weights over
    its T keys)."""
    import torch.nn.functional as F

    q, k, v = (tensor((B, T, H, D)) for _ in range(3))
    mask = torch.zeros(B, T, dtype=torch.bool, device="cuda")
    if B > 1:
        mask[1, T // 2:] = True
    if B > 2:
        mask[2, :] = True
    ref = enc_attn.encoder_attention_plain(q.float(), k.float(), v.float(), mask)
    bf_err = max_err(enc_attn.encoder_attention_cuda(q, k, v, mask), ref)
    check(f"{label} bf16 kernel vs fp32 plain", bf_err, 2e-2)
    err = max_err(enc_attn.encoder_attention_cuda(q.float(), k.float(), v.float(), mask), ref)
    check(f"{label} fp32 kernel vs fp32 plain", err, 1e-4)
    if not timed:
        return dict(max_abs_err=bf_err, fp32_max_abs_err=err)
    ms = cuda_ms(lambda: enc_attn.encoder_attention_cuda(q, k, v, mask))
    plain_ms = cuda_ms(lambda: enc_attn.encoder_attention_plain(q, k, v, mask))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    keep = ~mask[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep))
    n_bytes = 4 * B * T * H * D * 2 + B * T
    flops = 4 * B * H * T * T * D
    b_ms, b_by = bound_ms(n_bytes, flops)
    rates = rate_fields(flops, ms, b_ms)
    log(f"  {label} B{B} T{T} H{H} D{D}: kernel {ms:.4f} ms ({rates['tflops']:.1f} TFLOP/s, "
        f"{100 * rates['bound_share']:.1f} % of bound), plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=bf_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, **rates)


def k2_case(torch, conv_tail, tensor, B, T1, per_layer=False, timed=True):
    """K2's six layers at one input length: accuracy (bf16 and fp32, against
    the output's max); unless not ``timed``, times and bound; with
    per_layer, each layer's time beside its cuDNN conv + GELU."""
    CH = conv_tail.CH
    x = torch.nn.functional.gelu(tensor((B, T1, CH), dtype=torch.float32)).to(torch.bfloat16)
    ws = [tensor((CH, CH, k), scale=(2.0 / (k * CH)) ** 0.5) for k, _ in conv_tail.TAIL_SPEC]
    ref = conv_tail.conv_tail_plain(x.float(), [w.float() for w in ws])
    scale = float(ref.abs().max())
    bf_err = max_err(conv_tail.conv_tail_cuda(x, ws), ref)
    check(f"B{B} T1 {T1} bf16 kernel vs fp32 plain (6 layers, bf16 between layers)", bf_err,
          3e-2 * scale)
    err = max_err(conv_tail.conv_tail_cuda(x.float(), [w.float() for w in ws]), ref)
    check(f"B{B} T1 {T1} fp32 kernel vs fp32 plain", err, 1e-4 * scale)
    if not timed:
        return dict(max_abs_err=bf_err, fp32_max_abs_err=err, output_max=scale)
    ms = cuda_ms(lambda: conv_tail.conv_tail_cuda(x, ws), reps=5)
    plain_ms = cuda_ms(lambda: conv_tail.conv_tail_plain(x, ws), reps=5)
    lens = [T1]
    flops = 0
    for k, s in conv_tail.TAIL_SPEC:
        lens.append((lens[-1] - k) // s + 1)
        flops += 2 * B * lens[-1] * k * CH * CH
    n_bytes = (B * T1 * CH + sum(w.numel() for w in ws) + B * lens[-1] * CH) * 2
    b_ms, b_by = bound_ms(n_bytes, flops)
    rates = rate_fields(flops, ms, b_ms)
    log(f"  B{B} T1 {T1} -> T6 {lens[-1]}, {flops / 1e9:.1f} GFLOP: kernel {ms:.3f} ms "
        f"({rates['tflops']:.1f} TFLOP/s, {100 * rates['bound_share']:.1f} % of bound), "
        f"plain (F.conv1d stack) {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    # the plain version is one cuDNN conv + GELU per layer: the library yardstick
    rec = dict(max_abs_err=bf_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=plain_ms, **rates)
    if per_layer:
        rec["layers"], y = [], x
        for i, (w, t_out) in enumerate(zip(ws, lens[1:])):
            layer_flops = 2 * B * t_out * w.shape[2] * CH * CH
            layer_ms = cuda_ms(lambda y=y, w=w: conv_tail.conv_tail_cuda(y, [w]), reps=10)
            lib_ms = cuda_ms(lambda y=y, w=w: torch.nn.functional.gelu(
                torch.nn.functional.conv1d(y.transpose(1, 2), w, stride=2)), reps=10)
            log(f"    layer {i + 1}: M {B * t_out}, depth {w.shape[2] * CH}: kernel "
                f"{layer_ms:.4f} ms ({layer_flops / layer_ms / 1e9:.0f} TFLOP/s), cuDNN conv + "
                f"GELU {lib_ms:.4f} ms")
            rec["layers"].append(dict(ms=layer_ms, library_ms=lib_ms,
                                      tflops=layer_flops / layer_ms / 1e9))
            y = conv_tail.conv_tail_cuda(y, [w])
    return rec


def k3_inputs(torch, tensor, rng, S, C, H, L, D=64):
    """Seeded bf16 K3 inputs; every row of the ancestry map is random, the
    row of the step itself included."""
    N = S * C
    q, k_new, v_new = (tensor((N, H, D)) for _ in range(3))
    kc, vc = tensor((N, H, L, D)), tensor((N, H, L, D))
    anc_np = rng.integers(0, C, size=(L + 1, N)).astype(np.int32)
    return q, k_new, v_new, kc, vc, torch.tensor(anc_np, device="cuda"), anc_np


def k3_step(torch, dec_attn, inputs, label, C, idx, timed=True):
    """K3 at one step of one shape: accuracy (bf16 and fp32 against the fp32
    plain version), the cache after the call bit-equal to the plain
    version's; unless not ``timed``, times and bound. Cache rows past the
    step are NaN."""
    q, k_new, v_new, kc, vc, anc, anc_np = inputs
    N, H, L, D = kc.shape
    S = N // C
    kc, vc = kc.clone(), vc.clone()
    kc[:, :, idx + 1:], vc[:, :, idx + 1:] = float("nan"), float("nan")
    kc32, vc32 = kc.float(), vc.float()
    ref = dec_attn.decode_attention_plain(q.float(), k_new.float(), v_new.float(), kc32, vc32,
                                          anc, idx, C)
    kc_k, vc_k = kc.clone(), vc.clone()
    out_bf = dec_attn.decode_attention_cuda(q, k_new, v_new, kc_k, vc_k, anc, idx, C)
    bf_err = max_err(out_bf, ref)
    label = f"{label} step {idx} L {L}"
    check(f"{label} bf16 kernel vs fp32 plain", bf_err, 2e-2)
    for got, want in ((kc_k, kc32), (vc_k, vc32)):
        if not torch.equal(got.float().nan_to_num(nan=7.0), want.nan_to_num(nan=7.0)):
            raise AssertionError(f"{label}: bf16 cache after the call differs from the plain one")
    kc_f, vc_f = kc.float(), vc.float()
    err = max_err(dec_attn.decode_attention_cuda(q.float(), k_new.float(), v_new.float(), kc_f,
                                                 vc_f, anc, idx, C), ref)
    check(f"{label} fp32 kernel vs fp32 plain", err, 1e-4)
    if not (torch.equal(kc_f.nan_to_num(nan=7.0), kc32.nan_to_num(nan=7.0))
            and torch.equal(vc_f.nan_to_num(nan=7.0), vc32.nan_to_num(nan=7.0))):
        raise AssertionError(f"{label}: fp32 cache after the call differs from the plain one")
    log(f"  {label} cache writes (bf16 and fp32): bit-equal to the plain version's")
    if not timed:
        return dict(max_abs_err=bf_err, fp32_max_abs_err=err)
    ms = cuda_ms(lambda: dec_attn.decode_attention_cuda(q, k_new, v_new, kc_k, vc_k, anc, idx, C),
                 reps=50)
    plain_ms = cuda_ms(lambda: dec_attn.decode_attention_plain(q, k_new, v_new, kc_k, vc_k, anc,
                                                               idx, C), reps=50)
    n_bytes = k3_bytes(anc_np, S, C, H, D, idx, 2)
    flops = 4 * N * H * (idx + 1) * D
    b_ms, b_by = bound_ms(n_bytes, flops)
    rec = dict(max_abs_err=bf_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, bound_share=b_ms / ms, parent_ms=None)
    log(f"  {label} S{S} C{C} H{H} D{D}: {n_bytes / 1e6:.2f} MB, kernel {ms:.4f} ms "
        f"({100 * b_ms / ms:.1f} % of bound), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    return rec


def k3_bytes(anc_np, S, C, H, D, idx, itemsize):
    """The bytes one K3 call must move: the cache rows the step reads
    (distinct ancestor columns per (sentence, time) before the step; the
    step's own row comes from k_new / v_new), q, k_new and v_new, the new
    rows written into the caches, the ancestry rows and the output."""
    N = S * C
    rows = sum(len(set(anc_np[l, s * C:(s + 1) * C])) for s in range(S) for l in range(idx))
    return ((2 * rows + 6 * N) * H * D * itemsize  # rows read, q / k_new / v_new, rows written, out
            + (idx + 1) * N * 4)


def k3_case(torch, dec_attn, tensor, rng, label, C, H):
    """K3 at one path's shape (8 sentences, a 64-step decode) at steps 63, 31
    and 0, and at step 150 of a 200-long cache (2 sentences: three time
    tiles in bf16, five in fp32). The record's main numbers are step 63's;
    `steps` holds the others; `steps_0_63_ms` is the measured device time of
    64 launches back to back, one at each step 0..63 in order: what one
    decoder layer launches over a 64-step decode."""
    inputs = k3_inputs(torch, tensor, rng, 8, C, H, 64)
    recs = {idx: k3_step(torch, dec_attn, inputs, label, C, idx) for idx in (63, 31, 0)}
    long = k3_step(torch, dec_attn, k3_inputs(torch, tensor, rng, 2, C, H, 200), label, C, 150)
    q, k_new, v_new, kc, vc, anc, _ = inputs

    def every_step():
        for idx in range(64):
            dec_attn.decode_attention_cuda(q, k_new, v_new, kc, vc, anc, idx, C)

    rec = dict(recs[63], steps={"0": recs[0], "31": recs[31], "150_of_200": long},
               steps_0_63_ms=cuda_ms(every_step, reps=6), parent_steps_0_63_ms=None)
    log(f"  {label}: 64 launches, steps 0..63 in order, back to back: "
        f"{rec['steps_0_63_ms']:.4f} ms")
    return rec


def k3_host_us(torch, dec_attn, tensor, rng, calls=1000):
    """Host time of one decode_attention_cuda call at the flagship shape:
    `calls` calls back to back on the host clock, one synchronize after."""
    q, k_new, v_new, kc, vc, anc, _ = k3_inputs(torch, tensor, rng, 8, 10, 8, 64)
    dec_attn.decode_attention_cuda(q, k_new, v_new, kc, vc, anc, 63, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        dec_attn.decode_attention_cuda(q, k_new, v_new, kc, vc, anc, 63, 10)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def k3_misaligned_raises(torch, dec_attn, tensor, rng):
    """A query that is not 16-byte aligned must raise, not launch."""
    q, k_new, v_new, kc, vc, anc, _ = k3_inputs(torch, tensor, rng, 1, 5, 4, 8)
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:].view_as(q).copy_(q)
    try:
        dec_attn.decode_attention_cuda(odd, k_new, v_new, kc, vc, anc, 3, 5)
    except (RuntimeError, ValueError) as e:
        log(f"  misaligned q raises: {e}")
        return
    raise AssertionError("decode_attention_cuda took a misaligned q")


def k4_flops(frames: int, mel_w, fft_flops: float) -> float:
    """Operations of the log-mel for `frames` frames with an FFT of
    `fft_flops` a frame: framing (mean, DC removal, pre-emphasis, window: 5 a
    sample), power (3 a bin), the mel sums over the non-zero weights (2 each)
    and one log a mel bin."""
    per_frame = (5 * 400 + fft_flops + 3 * 257 + 2 * int((mel_w != 0).sum())
                 + mel_w.shape[0])
    return float(frames * per_frame)


def k4_check(torch, lm, wav, label, frames):
    """One K4 input against the plain version in fp32 (5e-4, the TPU
    kernel's tolerance) and in fp64 (1e-5: K4 computes in fp64, so it must
    agree with the exact log-mel to fp32 rounding). Returns the output and
    both errors."""
    got, ref = lm.logmel_cuda(wav), lm.logmel_plain(wav)
    if got.shape != (wav.shape[0], frames, 80):
        raise AssertionError(f"{label}: output {tuple(got.shape)}, expected {frames} frames")
    err = max_err(got, ref)
    check(f"{label} -> F{frames}, kernel vs fp32 plain (log values)", err, 5e-4)
    exact_err = max_err(got, lm.logmel_plain(wav.double()))
    check(f"{label} -> F{frames}, kernel vs fp64 plain", exact_err, 1e-5)
    return got, ref, err, exact_err


def k4_case(torch, lm):
    """K4 on batch 8 of 6 s (598 frames a row; rows at amplitude 0.1 and 1.0,
    row 3 zero after 2 s), on one row of 33,000 samples (204 frames, not a
    multiple of the kernel's 8-frame tile) and on three rows of 16,085
    samples (99 frames: the last frame has no partner in its transform, and
    the rows start at addresses that are not 16-byte aligned)."""
    from chimera_st_tpu_torch.ops.fbank import mel_filterbank, num_frames

    rng = np.random.default_rng(4)
    B, T, M = 8, 96000, 80
    amp = np.where(np.arange(B) % 2 == 0, 0.1, 1.0)[:, None]
    wav_np = (rng.normal(size=(B, T)) * amp).astype(np.float32)
    wav_np[3, 32000:] = 0.0
    wav = torch.tensor(wav_np, device="cuda")
    F = num_frames(T)
    got, ref, err, exact_err = k4_check(torch, lm, wav, f"B{B} T{T}", F)
    zero_from = -(-32000 // 160)  # first frame that starts past the real samples
    if not torch.equal(got[3, zero_from:], ref[3, zero_from:]):
        raise AssertionError("all-zero frames differ from the plain version")
    log(f"  row 3, frames {zero_from}..{F - 1} (all zero): equal to the plain version exactly")
    short = torch.tensor(rng.normal(size=(1, 33000)).astype(np.float32), device="cuda")
    k4_check(torch, lm, short, "B1 T33000", 204)
    odd_np = (rng.normal(size=(3, 16085)) * 0.3).astype(np.float32)
    odd_np[1, 8160:] = 0.0  # frame 51 on: frame 50 shares its transform with a zero frame
    odd = torch.tensor(odd_np, device="cuda")
    got_o, ref_o, _, _ = k4_check(torch, lm, odd, "B3 T16085", 99)
    if not torch.equal(got_o[1, 51:], ref_o[1, 51:]):
        raise AssertionError("all-zero frames of the odd-count input differ from the plain version")
    ms = cuda_ms(lambda: lm.logmel_cuda(wav))
    plain_ms = cuda_ms(lambda: lm.logmel_plain(wav))
    mel_w = mel_filterbank(M, 512, 16000)
    n_bytes = 4 * (B * T + B * F * M + 400 + mel_w.size)
    # the function's least work: a real-input 512-point FFT, 2.5 N log2 N
    # (half a complex FFT), at the fp32 peak (fp32 in and out)
    flops = k4_flops(B * F, mel_w, 2.5 * 512 * 9)
    b_ms, b_by = bound_ms(n_bytes, flops, FP32_FLOPS)
    # what the kernel's design does, per frame: half of a complex 512-point
    # transform of 3 passes x 64 radix-8 butterflies (56 each), 2 passes with
    # 7 twiddle products and 7 twiddle powers a butterfly (6 each), in fp64
    design_flops = k4_flops(B * F, mel_w, (3 * 64 * 56 + 2 * 64 * 14 * 6) / 2)
    rec = dict(max_abs_err=err, max_abs_err_fp64_plain=exact_err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None, bound_share=b_ms / ms,
               parent_ms=None)
    log(f"  B{B} F{F}: {flops / 1e9:.4f} GFLOP, {n_bytes / 1e6:.2f} MB: kernel {ms:.4f} ms "
        f"({100 * b_ms / ms:.1f} % of bound), plain (unfold + torch.fft.rfft + matmul) "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}; operations {flops / FP32_FLOPS * 1e3:.5f} ms at the fp32 CUDA-core peak, "
        f"bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms); the kernel's fp64 design does "
        f"{design_flops / 1e9:.4f} GFLOP = {design_flops / FP64_FLOPS * 1e3:.5f} ms at the "
        f"fp64 CUDA-core peak")
    return rec


def phase_k3_k4(torch, dec_attn, lm):
    """Phase 3 for K3 and K4, from seeds of their own, so that the same
    cases run on another tree's kernels (--kernels-of) see the same inputs."""
    # ---- K3: 8 sentences, a 64-step decode: flagship beam 10 with 8 heads,
    # fbank beam 5 with 4 heads
    log("K3 decode_attention")
    tensor, rng = Inputs(torch, 5), np.random.default_rng(1)
    k3 = {label: k3_case(torch, dec_attn, tensor, rng, label, C, H)
          for label, C, H in (("flagship", 10, 8), ("fbank", 5, 4))}
    host_us = k3_host_us(torch, dec_attn, tensor, rng)
    log(f"  host time of one decode_attention_cuda call (flagship shape): {host_us:.2f} us")
    # ---- K4: log-mel of 8 utterances of 6 s
    log("K4 logmel")
    return [dict(name="decode_attention", route="cuda",
                 source="chimera_st_tpu_torch/csrc/decode_attention.cu",
                 replaces="chimera_st_tpu/ops/pallas_decode_attention.py:59",
                 **k3["flagship"], fbank_shape=k3["fbank"], host_us=host_us),
            dict(name="logmel", route="cuda", source="chimera_st_tpu_torch/csrc/logmel.cu",
                 replaces="chimera_st_tpu/ops/pallas_logmel.py:108", **k4_case(torch, lm))]


def merge_parent(records, parent_dir: Path) -> None:
    """Times an earlier tree's K3 and K4 on this card in this run: this
    script runs once more, in a process of its own, with the package of the
    tree under `parent_dir` (a `git archive` of a commit) in place of this
    one's, through the same cases and the same wrappers
    (`decode_attention_cuda`, `logmel_cuda`, `*_plain`). Its times go beside
    the new ones as `parent_ms` / `parent_steps_0_63_ms`."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kernels-of",
                          str(parent_dir)], capture_output=True, text=True, timeout=600)
    for line in run.stdout.splitlines()[:-1]:
        log(f"  [{parent_dir.name}] {line}")
    if run.returncode:
        raise RuntimeError(f"K3 / K4 of {parent_dir} failed:\n{run.stderr[-4000:]}")
    old = {r["name"]: r for r in json.loads(run.stdout.splitlines()[-1])["kernels"]}

    def merge(rec, was, label):
        rec["parent_ms"] = was["ms"]
        note = f"  {label}: {rec['ms']:.4f} ms, earlier kernel {was['ms']:.4f} ms"
        if "steps_0_63_ms" in rec:
            rec["parent_steps_0_63_ms"] = was["steps_0_63_ms"]
            note += (f"; steps 0..63 {rec['steps_0_63_ms']:.4f} ms, earlier "
                     f"{was['steps_0_63_ms']:.4f} ms")
        log(note)
        for key, sub in rec.get("steps", {}).items():
            merge(sub, was["steps"][key], f"{label} step {key}")

    for rec in records:
        if rec["name"] in old:
            merge(rec, old[rec["name"]], rec["name"])
            if "fbank_shape" in rec:
                merge(rec["fbank_shape"], old[rec["name"]]["fbank_shape"],
                      f"{rec['name']} fbank")


def phase_kernels(torch, ops):
    """Phase 3. Returns the per-kernel records of the report line."""
    from chimera_st_tpu_torch.ops import _build

    enc_attn, conv_tail, dec_attn, lm = ops
    tensor = Inputs(torch, 0)
    records = []
    stream = torch.cuda.current_stream().cuda_stream
    empty = _build.kernel("launch_floor")
    floor_ms = cuda_ms(lambda: _build.check_launch("launch_floor", empty(stream)), reps=50)
    log(f"launch floor: an empty kernel takes {floor_ms:.5f} ms a launch, back to back")

    # ---- K1: wav2vec2 trunk (T 299, D 96), shared encoder (T 75, D 64),
    # fbank encoder of a 6 s utterance (598 frames -> T 150, H 4, D 64), a
    # 30 s trunk (T 1,499: no cap on T), T 65 (one ragged key and query tile),
    # the trunk as a released checkpoint builds it (12 heads of 64), and head
    # dim 128 at the MT shapes of transformer_iwslt_de_en (512 / 4 heads)
    log("K1 encoder_attention")
    k1 = {label: k1_case(torch, enc_attn, tensor, label, B, T, H, D)
          for label, B, T, H, D in (("trunk", 8, 299, 8, 96), ("shared", 8, 75, 8, 64),
                                    ("fbank", 8, 150, 4, 64), ("trunk_30s", 2, 1499, 8, 96),
                                    ("ragged", 8, 65, 8, 64), ("trunk_h12", 8, 299, 12, 64),
                                    ("d128_T64", 32, 64, 4, 128),
                                    ("d128_T128", 32, 128, 4, 128))}
    records.append(dict(name="encoder_attention", route="cuda",
                        source="chimera_st_tpu_torch/csrc/encoder_attention.cu",
                        replaces="chimera_st_tpu/ops/pallas_attention.py:31",
                        launches_of=enc_attn.encoder_attention, **k1.pop("trunk"),
                        shapes=k1))

    # ---- K2: conv tail of a 6 s utterance (T1 = 19199), and of 1.5 s clips
    # at batch 3 (T1 = 4799: a ragged last tile in every batch row)
    log("K2 conv_tail")
    k2 = {label: k2_case(torch, conv_tail, tensor, B, T1, per_layer=label == "6s")
          for label, B, T1 in (("6s", 8, 19199), ("1.5s", 3, 4799))}
    records.append(dict(name="conv_tail", route="cuda",
                        source="chimera_st_tpu_torch/csrc/conv_tail.cu",
                        replaces="chimera_st_tpu/ops/pallas_conv.py:146",
                        launches_of=conv_tail.conv_tail, **k2.pop("6s"), shapes=k2))

    for rec, fn in zip(phase_k3_k4(torch, dec_attn, lm), (dec_attn.decode_attention, lm.logmel)):
        records.append(dict(rec, launches_of=fn, launch_floor_ms=floor_ms))
    next(r for r in records if r["name"] == "decode_attention")["shapes"] = {
        "d128_S32_C5_H4": k3_d128_case(torch, dec_attn, tensor),
        "d128_S32_C4_H8": k3_d128_case(torch, dec_attn, tensor, "d128_wiki103", 4, 8),
        **k3_wide_cases(torch, dec_attn, tensor)}
    k3_misaligned_raises(torch, dec_attn, tensor, np.random.default_rng(2))
    return records


def k3_d128_case(torch, dec_attn, tensor, label="d128", C=5, H=4):
    """K3 at head dim 128, by default the MT decode's shape of
    transformer_iwslt_de_en (32 sentences x beam 5, 4 heads, a 64-step
    cache; with C 4 and H 8 the transformer_lm_wiki103 LM's in the fused
    decode of lm_fusion_adaptive) at steps 63, 31 and 0, as phase 3 holds
    it; beside it SDPA over the rows the ancestry selects, gathered
    beforehand (not the same function: K3 also gathers and writes the
    cache, so its library_ms stays null)."""
    import torch.nn.functional as F

    log(f"K3 decode_attention at head dim 128, beam {C}, {H} heads")
    inputs = k3_inputs(torch, tensor, np.random.default_rng(3), 32, C, H, 64, D=128)
    steps = {idx: k3_step(torch, dec_attn, inputs, label, C, idx) for idx in (63, 31, 0)}
    q, _, _, kc, vc, anc, _ = inputs
    N = q.shape[0]
    src = (torch.arange(N, device="cuda") // C * C)[None, :] + anc[:64].long()
    t = torch.arange(64, device="cuda")[:, None]
    kg, vg = (c[src, :, t].permute(1, 2, 0, 3).contiguous() for c in (kc, vc))  # [N, H, 64, D]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg), reps=50)
    log(f"  {label} step 63: SDPA over the 64 gathered rows (no gather, no cache write) "
        f"{sdpa_ms:.4f} ms beside the kernel's {steps[63]['ms']:.4f} ms")
    return dict(steps[63], steps={"0": steps[0], "31": steps[31]},
                sdpa_on_gathered_rows_ms=sdpa_ms)


SASS_OPS = ("HGMMA", "HMMA", "LDGSTS", "DFMA", "LDL", "STL")


def sass_check(lib: Path, out_dir: Path) -> dict:
    """Counts, per kernel of the built library's SASS (cuobjdump), the
    instructions the designs promise: the bf16 K1 and K2 kernels must hold
    tensor-core HGMMA (wgmma); K3 the asynchronous global -> shared copy
    (LDGSTS, from cp.async); K4 fp64 fused multiply-adds (DFMA) and no
    local-memory load or store (LDL / STL: its register arrays stayed in
    registers). Raises where cuobjdump is missing. Returns the counts."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found: the library's SASS cannot be checked")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in SASS_OPS:
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1
    short = {}
    for fn, c in counts.items():
        name = next((k for k in ("encoder_attention_tc_kernel", "encoder_attention_f32_kernel",
                                 "conv_tail_tc_kernel", "conv_tail_f32_kernel",
                                 "decode_attention_kernel", "logmel_kernel") if k in fn), fn)
        tag = "<64>" if "ILi64E" in fn else "<96>" if "ILi96E" in fn else ""
        total = short.setdefault(name + tag, dict.fromkeys(SASS_OPS, 0))
        for op in total:
            total[op] += c[op]
    (out_dir / "chip_smoke_sass.json").write_text(json.dumps(short, indent=1))
    for name, c in short.items():
        log(f"  sass {name}: " + ", ".join(f"{op} {n}" for op, n in c.items()))

    def need(name, op, present=True):
        n = short.get(name, {}).get(op, 0 if present else 1)
        if (n > 0) != present:
            raise AssertionError(f"{name}: {op} x{n} in the built library's SASS, expected "
                                 f"{'some' if present else 'none'}")

    for name in ("encoder_attention_tc_kernel<64>", "encoder_attention_tc_kernel<96>",
                 "conv_tail_tc_kernel"):
        need(name, "HGMMA")
    need("decode_attention_kernel", "LDGSTS")
    need("logmel_kernel", "DFMA")
    need("logmel_kernel", "LDL", present=False)
    need("logmel_kernel", "STL", present=False)
    return short


def ptxas_report(build_log: str, names=("decode_attention_kernel", "logmel_kernel",
                                        "encoder_attention_tc")) -> None:
    """Prints registers, spill bytes and shared memory of the named kernels
    from the compiler's -Xptxas=-v output."""
    import re

    fn, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if any(n in m.group(1) for n in names) else None
        elif fn and "spill" in line:
            spill = line.strip()
        elif fn and "Used" in line:
            log(f"  ptxas {fn}: {line.split(':', 1)[1].strip()}; {spill}")
            fn = None


def make_audio(rng, batch: int, seconds_lo: float, seconds_hi: float):
    """Seeded waveforms of random lengths, zero-padded to the longest, and
    their padding mask (True = pad)."""
    lengths = (rng.uniform(seconds_lo, seconds_hi, size=batch) * 16000).astype(np.int64)
    T = int(lengths.max())
    wav = (rng.normal(size=(batch, T)) * 0.1).astype(np.float32)
    mask = np.arange(T)[None, :] >= lengths[:, None]
    wav[mask] = 0.0
    return wav, mask


def phase_parity(torch, label, build_model, settings):
    """Phase 4: fp32 slice on the card (kernels) vs on the CPU (plain)."""
    from chimera_st_tpu_torch.generation.generator import SequenceGenerator

    log(f"parity ({label}): fp32 full width, batch 2, card (kernels) vs CPU (plain versions)")
    gpu_model = build_model("cuda", torch.float32)
    cpu_model = build_model("cpu", torch.float32)
    wav, mask = make_audio(np.random.default_rng(1), 2, 2.0, 3.0)
    results = {}
    for name, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        dev = torch.device(name)
        src, pm = torch.tensor(wav, device=dev), torch.tensor(mask, device=dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            enc, _ = model.encode_audio(src, pm)
        toks, scores, lens = SequenceGenerator(model, settings).generate_audio(src, pm)
        results[name] = [t.cpu() for t in (enc, toks, scores, lens)]
        log(f"  {name}: {time.perf_counter() - t0:.2f} s")
    (eg, tg, sg, lg), (ec, tc, sc, lc) = results["cuda"], results["cpu"]
    check("encoder output, card vs CPU", max_err(eg, ec), 1e-3)
    for b in range(tg.shape[0]):
        if not torch.equal(tg[b, 0], tc[b, 0]) or int(lg[b, 0]) != int(lc[b, 0]):
            raise AssertionError(f"best hypothesis of sentence {b} differs: {tg[b, 0].tolist()} "
                                 f"vs {tc[b, 0].tolist()}")
    log(f"  best hypotheses token-identical; lengths {lg[:, 0].tolist()}")
    check("best scores, card vs CPU", max_err(sg[:, 0], sc[:, 0]), 1e-4)
    del gpu_model, cpu_model


def phase_serve(torch, label, model, settings, kernels, on_path, seed, profile=False):
    """Phase 5 for one path: bf16 serving, counts zeroed just before."""
    from chimera_st_tpu_torch.generation.generator import SequenceGenerator

    s = settings
    log(f"serve ({label}): bf16, beam {s.beam_size}, max_decode_len {s.max_decode_len}, "
        f"len_penalty {s.len_penalty}, min_len {s.min_len}, batch 8")
    gen = SequenceGenerator(model, settings)
    rng = np.random.default_rng(seed)
    batches = [make_audio(rng, 8, 2.0, 6.0) for _ in range(SERVE_BATCHES + 1)]

    def serve(wav, mask):
        src = torch.tensor(wav, device="cuda")
        pm = torch.tensor(mask, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            enc, enc_mask = model.encode_audio(src, pm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks, scores, lens = gen.generate_from_encoder(enc, enc_mask)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (toks, scores, lens), t1 - t0, t2 - t1

    serve(*batches[0])  # warm-up: cuBLAS/cuDNN handles and plans
    for fn in kernels:
        fn.launches = 0
    K, L = s.beam_size, s.max_decode_len
    for i, (wav, mask) in enumerate(batches[1:]):
        (toks, scores, lens), t_enc, t_dec = serve(wav, mask)
        B = wav.shape[0]
        wall = t_enc + t_dec
        log(f"  batch {i}: {B} utts, {wav.shape[1] / 16000:.2f} s padded, wall {wall:.3f} s, "
            f"{B / wall:.2f} utt/s, encode {t_enc * 1e3:.1f} ms, decode {t_dec * 1e3:.1f} ms")
        toks, scores, lens = toks.cpu(), scores.cpu(), lens.cpu()
        if toks.shape != (B, K, L) or not torch.isfinite(scores).all():
            raise AssertionError(f"bad output: tokens {tuple(toks.shape)}, scores {scores}")
        for b in range(B):
            n = int(lens[b, 0])
            if not s.min_len + 1 <= n <= L or int(toks[b, 0, n - 1]) != gen.eos:
                raise AssertionError(f"hypothesis {b} does not end in eos within "
                                     f"[{s.min_len + 1}, {L}]")
    counts = {fn.__name__: fn.launches for fn in kernels}
    log(f"  launches during serve ({label}): {counts}")
    for name, n in counts.items():
        if n != on_path.get(name, 0) * SERVE_BATCHES:
            raise AssertionError(f"kernel {name} launched {n}x on the {label} path, not "
                                 f"{on_path.get(name, 0)} a batch")
    if profile:
        phase_profile(torch, label, serve, batches[1])
    return counts


def trace_busy(path: Path) -> dict:
    """The device's busy share in a torch.profiler Chrome trace (what a
    CLI's ``--profile DIR`` writes as DIR/trace.json): the union of the
    kernel, copy and set intervals over the span from the trace's first
    event to its last. The script's one definition of the busy share."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        raise RuntimeError(f"{path}: the trace holds no device events")
    busy, end = 0.0, float("-inf")
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = (max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
            - min(float(e["ts"]) for e in events))
    return {"wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3, "busy_share": busy / wall,
            "device_events": len(device)}


def profiler_busy(prof) -> dict:
    """trace_busy of a finished torch.profiler run."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return trace_busy(path)


def phase_profile(torch, label, serve, batch):
    """Optional (--profile): one more served batch under torch.profiler.
    Prints the device's busy share (trace_busy) and the device time by
    kernel, largest first (also written to chiprun_out/serve_profile_<path>.txt)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_enc, t_dec = serve(*batch)
    busy = profiler_busy(prof)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"profile ({label}): one batch of 8, encode {t_enc * 1e3:.1f} ms, decode "
        f"{t_dec * 1e3:.1f} ms; device busy {busy['device_busy_ms']:.1f} ms = "
        f"{100 * busy['busy_share']:.1f} % of the trace's {busy['wall_ms']:.1f} ms, "
        f"{sum(e.count for e in kernels)} launches")
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  {e.key[:110]}"
             for e in rows]
    for line in lines[:15]:
        log("  " + line)
    (ROOT / "chiprun_out" / f"serve_profile_{label}.txt").write_text("\n".join(lines) + "\n")
    return busy


def seeded_builder(torch, make, seed: int = 0):
    """build(device, dtype): the model from make(device) with the same
    seeded random weights every time (drawn once on the CPU from ``seed``)."""
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.models.layers import cast_compute_dtype_

    weights = {}

    def build(device, dtype):
        model = make(device)
        if not weights:
            weights.update(init_params_(make("cpu"), torch.Generator().manual_seed(seed))
                           .state_dict())
        model.load_state_dict(weights)
        return cast_compute_dtype_(model.eval(), dtype)

    return build


# ---- the CLI phases: a data directory and a fairseq-layout checkpoint made
# from a seed, then the port's generate / interactive entry points on them

CLI_WAVS = 24
CLI_BATCH = 8
W2V_CONV_FEATURE_LAYERS = "[(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512,2,2)] * 2"


def fairseq_state_dict(torch, model):
    """The state dict of the port's interlingua model in the layout of a
    fairseq fine-tune checkpoint (the inverse of
    checkpoint/torch_import.import_interlingua_state_dict): ``pos_conv``
    weight-normed (``weight_g`` the norm over dims 0 and 1, ``weight_v`` a
    rescaled copy), the tied ``output_projection`` alias, the trunk's
    pretraining-only heads and the sinusoidal dummies."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    key = "encoder.wav2vec_model.encoder.pos_conv.0."
    w = sd.pop(key + "weight")
    sd[key + "weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[key + "weight_v"] = 0.5 * w
    # tied: the alias of the embedding; untied: the model's own projection
    sd.setdefault("decoder.output_projection.weight", sd["decoder.embed_tokens.weight"])
    dim = model.cfg.w2v2_embed_dim
    sd["encoder.wav2vec_model.mask_emb"] = torch.rand(dim)
    sd["encoder.wav2vec_model.final_proj.weight"] = torch.zeros(256, dim)
    sd["encoder.wav2vec_model.final_proj.bias"] = torch.zeros(256)
    sd["encoder.embed_positions._float_tensor"] = torch.zeros(1)
    sd["decoder.embed_positions._float_tensor"] = torch.zeros(1)
    return sd


def make_cli_fixture(torch, root: Path, cfg, conv_feature_layers: str, seed: int = 7) -> dict:
    """Writes, with the port's own code: 24 wavs of 2-6 s (lengths multiples
    of 1,280 samples, the interactive CLI's padding step), the manifests
    ``tst_wave.tsv`` (all 24) and ``pairs.tsv`` (4 of them, longest first),
    10,000-entry target and source dictionaries, ``config_wave.yaml`` (as
    JSON, which is YAML) and a fairseq-layout ``.pt`` of the interlingua
    model ``cfg`` with seeded random weights, its ``args`` a Namespace with
    the trunk's dimensions nested under ``w2v_args`` as a released checkpoint
    has them (``conv_feature_layers`` is the expression string that stands
    for ``cfg.w2v2_conv_spec``). Returns the paths and the seeded model."""
    from argparse import Namespace

    from chimera_st_tpu_torch.data.audio import write_wav
    from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, init_params_

    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    words = [f"w{i}" for i in range(10000 - 4)]  # + bos, pad, eos, unk = 10,000
    for name in ("dict.txt", "src_dict.txt"):
        (root / name).write_text("".join(f"{w} 1\n" for w in words))
    rows = []
    for i in range(CLI_WAVS):
        n = 1280 * int(rng.integers(25, 76))  # 2.0 .. 6.0 s
        write_wav(str(root / "wavs" / f"u{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32))
        src = " ".join(rng.choice(words, size=int(rng.integers(5, 25))))
        tgt = " ".join(rng.choice(words, size=int(rng.integers(5, 25))))
        rows.append((f"u{i}", f"wavs/u{i}.wav:0:{n}", n, src, tgt))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\n"
    (root / "tst_wave.tsv").write_text(
        header + "".join("\t".join(map(str, r)) + "\n" for r in rows))
    pairs = sorted(rows[:8], key=lambda r: -r[2])[:4]
    if len({r[2] for r in pairs}) != 4:
        raise AssertionError("the four interactive wavs need distinct lengths")
    (root / "pairs.tsv").write_text(
        header + "".join("\t".join(map(str, r)) + "\n" for r in pairs))
    (root / "pairs.txt").write_text("".join(f"{root}/wavs/{r[0]}.wav\n" for r in pairs))
    (root / "config_wave.yaml").write_text(json.dumps({
        "audio_root": str(root), "use_audio_input": True, "vocab_filename": "dict.txt",
        "src_vocab_filename": "src_dict.txt"}))

    model = init_params_(ChimeraInterlinguaModel(cfg, device="cpu"),
                         torch.Generator().manual_seed(seed)).eval()
    ckpt = root / "chimera_seeded.pt"
    torch.save({"args": fixture_args(cfg, conv_feature_layers),
                "model": fairseq_state_dict(torch, model)}, str(ckpt))
    log(f"fixture: {CLI_WAVS} wavs, {sum(r[2] for r in rows) / 16000:.1f} s of audio, "
        f"dictionaries of 10000, {ckpt.name} {ckpt.stat().st_size / 1e6:.0f} MB "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    return dict(root=root, ckpt=ckpt, model=model, ids=[r[0] for r in rows],
                conv_feature_layers=conv_feature_layers)


def fixture_args(cfg, conv_feature_layers: str):
    """The ``args`` Namespace of a fairseq fine-tune checkpoint of the
    interlingua model ``cfg``, the trunk's dimensions nested under
    ``w2v_args`` as a released checkpoint has them."""
    from argparse import Namespace

    w2v_args = Namespace(
        encoder_embed_dim=cfg.w2v2_embed_dim, encoder_ffn_embed_dim=cfg.w2v2_ffn_dim,
        encoder_layers=cfg.w2v2_layers, encoder_attention_heads=cfg.w2v2_heads,
        conv_pos=cfg.w2v2_conv_pos, conv_pos_groups=cfg.w2v2_conv_pos_groups,
        conv_feature_layers=conv_feature_layers, extractor_mode="default", conv_bias=False)
    return Namespace(
        arch="s2t_transformer_w2v2_interlingua_base", encoder_embed_dim=cfg.encoder_embed_dim,
        encoder_ffn_embed_dim=cfg.encoder_ffn_dim, encoder_layers=cfg.encoder_layers,
        encoder_attention_heads=cfg.encoder_heads, decoder_embed_dim=cfg.decoder_embed_dim,
        decoder_ffn_embed_dim=cfg.decoder_ffn_dim, decoder_layers=cfg.decoder_layers,
        decoder_attention_heads=cfg.decoder_heads, interlingua_length=cfg.interlingua_length,
        interlingua_layers=cfg.interlingua_layers,
        conv_kernel_sizes=",".join(map(str, cfg.conv_kernel_sizes)),
        conv_channels=cfg.conv_channels, activation_fn=cfg.activation,
        share_decoder_input_output_embed=cfg.share_decoder_input_output_embed,
        max_target_positions=cfg.max_target_positions, w2v_args=w2v_args)


@contextlib.contextmanager
def recorded_shapes(enc_attn, conv_tail, dec_attn, seen=None):
    """While open, notes the input shape and dtype of every K1, K2 and K3
    launch (the wrappers reach ``encoder_attention_cuda`` / ``conv_tail_cuda``
    / ``decode_attention_cuda`` through their modules, where these stand in).
    Yields {kernel: [(shape, dtype)]} (``seen`` extended, where given), each
    distinct pair once, in the order of its first launch; K3's shape is the
    cache's (N, H, L, D) and the beam."""
    if seen is None:
        seen = {"encoder_attention": [], "conv_tail": [], "decode_attention": []}
    k1, k2 = enc_attn.encoder_attention_cuda, conv_tail.conv_tail_cuda
    k3 = dec_attn.decode_attention_cuda

    def note(name, shape, dtype):
        key = (tuple(shape), dtype)
        if key not in seen[name]:
            seen[name].append(key)

    def noted_k1(q, k, v, key_padding_mask=None):
        note("encoder_attention", q.shape, q.dtype)
        return k1(q, k, v, key_padding_mask)

    def noted_k2(x, weights):
        note("conv_tail", x.shape, x.dtype)
        return k2(x, weights)

    def noted_k3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam):
        note("decode_attention", (*k_cache.shape, beam), q.dtype)
        return k3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam)

    enc_attn.encoder_attention_cuda, conv_tail.conv_tail_cuda = noted_k1, noted_k2
    dec_attn.decode_attention_cuda = noted_k3
    try:
        yield seen
    finally:
        enc_attn.encoder_attention_cuda, conv_tail.conv_tail_cuda = k1, k2
        dec_attn.decode_attention_cuda = k3


@contextlib.contextmanager
def counted_decoder_steps():
    """While open, counts the decoder steps that run: yields [steps, layer
    steps] (every decoder's, a language model's too; the layer steps are
    the K3 launches they imply)."""
    from chimera_st_tpu_torch.models.transformer_decoder import TransformerDecoder

    steps = [0, 0]
    decoder_step = TransformerDecoder.step

    def counted_step(self, *args, **kwargs):
        steps[0] += 1
        steps[1] += len(self.layers)
        return decoder_step(self, *args, **kwargs)

    TransformerDecoder.step = counted_step
    try:
        yield steps
    finally:
        TransformerDecoder.step = decoder_step


# ---- the training phases: K1 / K2 backward, card-vs-CPU parity of one
# flagship step, and the recipe's operating point

def grad_err(got, ref) -> float:
    """Max abs error over a tensor's largest reference value."""
    return max_err(got, ref) / max(float(ref.abs().max()), 1e-30)


def k1_backward_case(torch, enc_attn, tensor, label, B, T, H, D):
    """K1 through ``EncoderAttentionFn`` (kernel forward, recomputed
    backward) in bf16 and fp32 against autograd through the plain version in
    fp32 on the same inputs; errors over each gradient's max. The
    backward's time beside its bound (10 B H T^2 D operations: the logits
    recomputed, dV, dP, dQ, dK)."""
    q, k, v, g = (tensor((B, T, H, D)) for _ in range(4))
    mask = torch.zeros(B, T, dtype=torch.bool, device="cuda")
    mask[1, T // 2:] = True
    if B > 2:
        mask[2, :] = True
    ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
    enc_attn.encoder_attention_plain(*ref_leaves, mask).backward(g.float())
    errs = {}
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        leaves = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        out = enc_attn.EncoderAttentionFn.apply(*leaves, mask)
        if out.grad_fn is None:
            raise AssertionError("K1's output has no grad_fn")
        out.backward(g.to(dtype))
        name = str(dtype).replace("torch.", "")
        errs[name] = max(grad_err(a.grad, r.grad) for a, r in zip(leaves, ref_leaves))
        check(f"{label} {name} dq/dk/dv through K1 vs fp32 plain autograd (over max)",
              errs[name], tol)
    ms = cuda_ms(lambda: enc_attn.encoder_attention_backward(q, k, v, mask, g), reps=5)
    b_ms, b_by = bound_ms(7 * B * T * H * D * 2 + B * T, 10 * B * H * T * T * D)
    # the library call: SDPA forward and backward, the padding a float mask
    # of -1e8 (the plain version's logit); [B, T, H, D] -> [B, H, T, D]
    bias = torch.zeros(B, 1, 1, T, dtype=q.dtype, device="cuda").masked_fill(
        mask[:, None, None, :], -1e8)
    gt = g.transpose(1, 2)

    def sdpa_forward_backward():
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=bias).backward(gt)

    lib_ms = cuda_ms(sdpa_forward_backward, reps=5)
    log(f"  {label} backward (fp32 recompute, plain PyTorch): {ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); SDPA forward + backward (bf16): {lib_ms:.4f} ms")
    return dict(backward_ms=ms, backward_bound_ms=b_ms, backward_bound_by=b_by,
                backward_library_ms=lib_ms, grad_err=errs)


def k2_backward_case(torch, conv_tail, tensor, B, T1):
    """K2 through ``ConvTailFn`` with fp32 weights (cast to x's dtype
    inside), bf16 and fp32 x, against autograd through the plain tail in
    fp32; errors over each gradient's max. The backward's time beside its
    bound (the recomputed forward and the dX and dW products: 3x the
    forward's operations)."""
    CH = conv_tail.CH
    x = torch.nn.functional.gelu(tensor((B, T1, CH), dtype=torch.float32)).to(torch.bfloat16)
    ws = [tensor((CH, CH, k), scale=(2.0 / (k * CH)) ** 0.5, dtype=torch.float32)
          for k, _ in conv_tail.TAIL_SPEC]
    ref_leaves = [x.float().requires_grad_()] + [w.clone().requires_grad_() for w in ws]
    y = conv_tail.conv_tail_plain(ref_leaves[0], ref_leaves[1:])
    g = tensor(tuple(y.shape))
    y.backward(g.float())
    errs = {}
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
        leaves = [x.detach().to(dtype).requires_grad_()] + [w.clone().requires_grad_() for w in ws]
        out = conv_tail.ConvTailFn.apply(*leaves)
        if out.grad_fn is None:
            raise AssertionError("K2's output has no grad_fn")
        out.backward(g.to(dtype))
        name = str(dtype).replace("torch.", "")
        errs[name] = max(grad_err(a.grad, r.grad) for a, r in zip(leaves, ref_leaves))
        check(f"B{B} T1 {T1} {name} dx/dW through K2 vs fp32 plain autograd (over max)",
              errs[name], tol)
        del leaves, out
    wb = [w.to(torch.bfloat16) for w in ws]
    ms = cuda_ms(lambda: conv_tail.conv_tail_backward(x, wb, g), reps=3)
    lens, flops = [T1], 0
    for k, s in conv_tail.TAIL_SPEC:
        lens.append((lens[-1] - k) // s + 1)
        flops += 2 * B * lens[-1] * k * CH * CH
    n_bytes = (2 * B * T1 * CH + 2 * sum(w.numel() for w in ws) + B * lens[-1] * CH) * 2
    b_ms, b_by = bound_ms(n_bytes, 3 * flops)
    log(f"  B{B} T1 {T1} backward (recompute + cuDNN dX/dW, bf16): {ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return dict(backward_ms=ms, backward_bound_ms=b_ms, backward_bound_by=b_by,
                grad_err=errs)


def phase_train_kernels(torch, enc_attn, conv_tail, records):
    """K1's and K2's training forms at the train phase's shapes: trunk (12
    heads of 64, and the default 8 of 96), shared encoder, 6 s conv tail."""
    log("train_kernels: K1 / K2 backward through their autograd Functions")
    tensor = Inputs(torch, 5)
    k1_rec, k2_rec = (next(r for r in records if r["name"] == n)
                      for n in ("encoder_attention", "conv_tail"))
    k1_rec["backward"] = {
        label: k1_backward_case(torch, enc_attn, tensor, label, B, T, H, D)
        for label, B, T, H, D in (("trunk_h12", 8, 299, 12, 64), ("trunk", 8, 299, 8, 96),
                                  ("shared", 8, 75, 8, 64))}
    k2_rec["backward"] = {"6s": k2_backward_case(torch, conv_tail, tensor, 8, 19199)}
    torch.cuda.empty_cache()


TRAIN_ARCH = {"arch": "s2t_transformer_w2v2_interlingua_base", "interlingua_length": 64,
              "w2v2_heads": 12}
TRAIN_CRITERION = {"_name": "triplet_st_mt_contrastive", "label_smoothing": 0.1,
                   "loss_ratio": (1.0, 1.0, 1.0)}
TRAIN_ADAM = {"_name": "adam", "adam_betas": "(0.9, 0.98)"}
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, w2v2_dropout=0.0,
                  w2v2_attention_dropout=0.0, w2v2_activation_dropout=0.0)


def train_task(fx):
    """The triplet task on the fixture, with ``train_wave.tsv``: the 24 wavs
    of the CLI manifest as a training split."""
    from chimera_st_tpu_torch.tasks import setup_task

    root = fx["root"]
    (root / "train_wave.tsv").write_text((root / "tst_wave.tsv").read_text())
    return setup_task({"_name": "triplet", "data": str(root), "config_yaml": "config_wave.yaml"})


def drawn_on_card(torch, model, seed: int):
    """``init_params_`` of a model built on the card, from a card generator
    seeded ``seed``: the same weights at every call, drawn (and first
    default-initialised by the builder) in a fraction of the host's time at
    these sizes. A parity check's CPU side takes a copy of them."""
    from chimera_st_tpu_torch.models.interlingua import init_params_

    return init_params_(model, torch.Generator(device="cuda").manual_seed(seed))


def train_model(torch, task, device, **overrides):
    """The recipe's model built for training (fp32 parameters, train mode)
    with seeded random weights, drawn on the card (drawn_on_card) and moved
    to ``device``."""
    model = task.build_model(dict(TRAIN_ARCH, **overrides), device="cuda", train=True)
    return drawn_on_card(torch, model, 11).to(device)


def gradient_gates(torch, label, mg, mc, gg, gc, keys, names):
    """The gradient gates of one fp32 update, card vs CPU from the same
    weights: the metrics ``mg`` / ``mc`` in ``keys`` within 1e-5 and gnorm
    within 1e-3 (relative); every gradient of ``names`` (``gg`` / ``gc``)
    within 1e-2 (L2 per tensor: fp32 round-off grows through the ReLU kinks
    and cuDNN's conv backward, a wrong backward would be O(1); a key
    projection's bias, whose exact gradient is 0 since a softmax row
    shifted by a constant does not change, against its weight's). Returns
    the relative loss, gnorm and largest gradient differences, and the
    tensors whose gradient is not 0 on both devices."""
    for key in keys:
        check(f"{label} {key} card vs CPU (relative)", abs(mg[key] - mc[key]) / abs(mc[key]),
              1e-5)
    check(f"{label} gnorm card vs CPU (relative)", abs(mg["gnorm"] - mc["gnorm"]) / mc["gnorm"],
          1e-3)
    live = [k for k in names if gc[k].abs().max() > 0 or gg[k].abs().max() > 0]
    rel = sorted(((float((gg[k] - gc[k]).norm() / gc[k[:-4] + "weight" if k.endswith(
        "k_proj.bias") else k].norm().clamp_min(1e-30)), k) for k in live), reverse=True)
    log(f"  {label} largest gradient differences (L2, relative): "
        + ", ".join(f"{k} {e:.2e}" for e, k in rel[:4]))
    check(f"{label} every gradient ({len(rel)} tensors) card vs CPU, |d| / |g| per tensor",
          rel[0][0], 1e-2)
    return {"loss_rel": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
            "gnorm_rel": abs(mg["gnorm"] - mc["gnorm"]) / mc["gnorm"],
            "grad_rel_max": rel[0][0]}, live


def compare_step(torch, label, cuda, cpu, before, keys=("loss", "nll_loss"), names=None,
                 lr=1e-4):
    """The gates of one fp32 Adam update, card vs CPU from the same
    weights. ``cuda`` / ``cpu`` are (metrics, gradients, parameters after),
    ``before`` the parameters before, ``names`` the trained tensors (default
    all), ``lr`` the update's learning rate. gradient_gates, then the
    parameters after the update: where the two gradients differ by d,
    Adam's first update may differ by up to lr * min(2, d / eps), the bound
    each parameter is held to (plus 4 fp32 roundings of the parameter and
    1e-6 lr for the two optimizers' own rounding). Every tensor whose
    gradient is not 0 on both devices must move. Returns gradient_gates'
    record."""
    (mg, gg, pg), (mc, gc, pc) = cuda, cpu
    names = list(gc) if names is None else names
    out, live = gradient_gates(torch, label, mg, mc, gg, gc, keys, names)
    eps = 1e-8
    excess, moved = 0.0, 0
    for k in names:
        allowed = lr * torch.clamp((gg[k] - gc[k]).abs() / eps, max=2.0) \
            + 4 * torch.finfo(torch.float32).eps * pc[k].abs() + 1e-6 * lr
        excess = max(excess, float(((pg[k] - pc[k]).abs() - allowed).max()))
        moved += int(not torch.equal(pc[k], before[k]))
    log(f"  {label} Adam update: {moved} of {len(names)} tensors moved ({len(names) - len(live)} "
        f"with a zero gradient); max |card - CPU| / lr "
        f"{max(max_err(pg[k], pc[k]) for k in names) / lr:.3e}")
    if excess > 0 or moved != len(live):
        raise AssertionError(f"{label} parity: {excess} beyond the bound, {moved} of "
                             f"{len(live)} tensors moved")
    return out


def phase_train_parity(torch, task):
    """One flagship step at full width in fp32 (TF32 off), every dropout 0,
    a batch of 2 from the fixture (flagship_step_parity)."""
    batch = next(iter(task.make_batch_iterator(task.dataset("train_wave"), max_sentences=2)
                      .next_epoch_itr(shuffle=False)))
    log(f"train_parity: fp32, every dropout 0, batch 2 ({batch['audio'].shape[1] / 16000:.2f} s "
        "padded), card (kernels) vs CPU (plain versions), one Adam update at lr 1e-4")
    flagship_step_parity(torch, "train", task, TRAIN_CRITERION, [batch],
                         ("loss", "st_loss", "mt_loss", "contrastive_loss"))


def flagship_step_parity(torch, label, task, crit_cfg, micro, keys):
    """One accumulated update of the recipe's model over ``micro`` at full
    width in fp32 (TF32 off), every dropout 0: on the card (K1, K2 through
    their Functions) and on the CPU (plain versions), held by compare_step
    (the metrics ``keys``, gnorm, every gradient, one Adam update at lr
    1e-4 on a fixed schedule)."""
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.train import TrainStep

    out = {}
    for device in ("cuda", "cpu"):
        model = train_model(torch, task, device, **NO_DROPOUT)
        step = TrainStep(model, task.build_criterion(crit_cfg),
                         build_optimizer(TRAIN_ADAM, model.parameters()),
                         build_lr_schedule({"_name": "fixed", "lr": 1e-4}),
                         compute_dtype=torch.float32)
        before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        t0 = time.perf_counter()
        metrics = step(micro)
        log(f"  {label} {device}: {time.perf_counter() - t0:.2f} s, loss {metrics['loss']:.4f}, "
            f"gnorm {metrics['gnorm']:.4f}")
        out[device] = (metrics, before, {k: p.grad.cpu() for k, p in model.named_parameters()},
                       {k: p.detach().cpu() for k, p in model.named_parameters()})
        del model, step
    (mg, before, gg, pg), (mc, _, gc, pc) = out["cuda"], out["cpu"]
    torch.cuda.empty_cache()
    return compare_step(torch, label, (mg, gg, pg), (mc, gc, pc), before, keys=keys)


def train_profile(torch, step, micro):
    """One update under torch.profiler: the device's busy share (trace_busy)
    and the device operations by time (also written to
    chiprun_out/train_profile.txt)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(micro)
        torch.cuda.synchronize()
    busy = profiler_busy(prof)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"  profile: one update, device busy {busy['device_busy_ms']:.1f} ms = "
        f"{100 * busy['busy_share']:.1f} % of the trace's {busy['wall_ms']:.1f} ms, "
        f"{sum(e.count for e in events)} launches")
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  {e.key[:110]}"
             for e in rows]
    for line in lines[:15]:
        log("  " + line)
    (ROOT / "chiprun_out" / "train_profile.txt").write_text("\n".join(lines) + "\n")
    return busy


TRAIN_UPDATES = 3  # timed, after one warm-up update


def phase_train(torch, task, kernels, profile=False):
    """The recipe's operating point: bf16 autocast over fp32 parameters, the
    triplet criterion (label smoothing 0.1, loss ratio 1 1 1), Adam (0.9,
    0.98) at inverse-sqrt lr 1e-4 with the warm-up cut to 4 updates, the
    24 fixture wavs through the task's iterator in micro-batches of 8: 3
    micro-batches an update. One warm-up update, then 3 timed, launch
    counts zeroed just before them; then the forward / backward split of
    one micro-batch, a NaN batch, and one update with both attention
    dropouts at 0 (K1 on the path). Returns the launch counts of both runs."""
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.train import TrainStep, prepare_batch

    micro = list(task.make_batch_iterator(task.dataset("train_wave"), max_sentences=8)
                 .next_epoch_itr(shuffle=False))
    audio_s = sum(float(b["audio_lengths"].sum()) for b in micro) / 16000
    tokens = sum(b["ntokens"] for b in micro)
    log(f"train: bf16 autocast, {len(micro)} micro-batches of 8 an update ({audio_s:.1f} s of "
        f"audio, {tokens:.0f} target tokens; padded to "
        f"{[round(b['audio'].shape[1] / 16000, 2) for b in micro]} s), Adam (0.9, 0.98), "
        "inverse_sqrt lr 1e-4, warm-up 4")

    def make_step(**overrides):
        model = train_model(torch, task, "cuda", **overrides)
        return TrainStep(model, task.build_criterion(TRAIN_CRITERION),
                         build_optimizer(TRAIN_ADAM, model.parameters()),
                         build_lr_schedule({"_name": "inverse_sqrt", "lr": 1e-4,
                                            "warmup_updates": 4}),
                         compute_dtype=torch.bfloat16, seed=0)

    step = make_step()
    model = step.model
    n_params = sum(p.numel() for p in model.parameters())
    step(micro)  # warm-up: cuBLAS / cuDNN plans; lr 0
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    history = [step(micro) for _ in range(TRAIN_UPDATES)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(history):
        log(f"  update {i + 1}: lr {m['lr']:.2e}, loss / token {m['loss'] / m['sample_size']:.4f} "
            f"(st {m['st_loss'] / m['sample_size']:.4f}, mt {m['mt_loss'] / m['sample_size']:.4f},"
            f" contrastive {m['contrastive_loss']:.3f}), gnorm {m['gnorm']:.4f}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["gnorm"])) or m["nonfinite_grad"]:
            raise AssertionError(f"update {i + 1} is not finite: {m}")
    moved = sum(not torch.equal(p, start[k]) for k, p in model.named_parameters())
    rec = {"updates_per_s": TRAIN_UPDATES / wall, "audio_s_per_s": TRAIN_UPDATES * audio_s / wall,
           "target_tokens_per_s": TRAIN_UPDATES * tokens / wall, "update_s": wall / TRAIN_UPDATES,
           "peak_memory_gb": peak / 1e9, "parameters": n_params, "launches": counts,
           "step": step.num_updates}
    log(f"  {TRAIN_UPDATES} updates in {wall:.2f} s: {rec['updates_per_s']:.3f} updates/s, "
        f"{rec['audio_s_per_s']:.1f} audio s/s, {rec['target_tokens_per_s']:.0f} target tokens/s; "
        f"peak memory {peak / 1e9:.2f} GB ({n_params / 1e6:.1f} M parameters); {moved} of "
        f"{len(start)} parameter tensors moved; step {step.num_updates}; launches {counts}")
    # K2 once a micro-batch (6 layers); attention dropout 0.1 keeps K1 off
    implied = {"encoder_attention": 0, "conv_tail": 6 * len(micro) * TRAIN_UPDATES,
               "decode_attention": 0, "logmel": 0}
    if counts != implied or step.num_updates != 1 + TRAIN_UPDATES or moved != len(start):
        raise AssertionError(f"train: launches {counts} (want {implied}), step "
                             f"{step.num_updates}, {moved} of {len(start)} tensors moved")

    # forward vs backward of one micro-batch (no update)
    b = prepare_batch(micro[0], "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with step.autocast():
        loss, _, _ = step.criterion(model, b, step.generator, step.num_updates)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    rec["forward_ms"], rec["backward_ms"] = (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3
    step.optimizer.optimizer.zero_grad(set_to_none=True)
    log(f"  one micro-batch of 8: forward (audio + text pass) {rec['forward_ms']:.1f} ms, "
        f"backward {rec['backward_ms']:.1f} ms")
    if profile:
        rec["profile"] = train_profile(torch, step, micro)

    # a NaN in the audio: nothing changes, the update is not counted
    n_updates = step.num_updates
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt_state = [{k: v.clone() for k, v in s.items()}
                 for s in step.optimizer.optimizer.state.values()]
    bad = dict(micro[0], audio=micro[0]["audio"].copy())
    bad["audio"][0, 100] = np.nan
    m = step([bad])
    same = all(torch.equal(p, params[k]) for k, p in model.named_parameters()) and all(
        torch.equal(v, old[k]) for s, old in zip(step.optimizer.optimizer.state.values(),
                                                 opt_state) for k, v in s.items())
    log(f"  NaN batch: gnorm {m['gnorm']}, nonfinite_grad {m['nonfinite_grad']}, step "
        f"{step.num_updates}, parameters and Adam state unchanged: {same}")
    if m["nonfinite_grad"] != 1.0 or step.num_updates != n_updates or not same:
        raise AssertionError("the NaN batch changed the state")
    del step, model, params, opt_state
    torch.cuda.empty_cache()

    # both attention dropouts 0: K1 runs in the trunk and the shared encoder
    step = make_step(attention_dropout=0.0, w2v2_attention_dropout=0.0)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(micro)
    torch.cuda.synchronize()
    counts0 = {fn.__name__: fn.launches for fn in kernels}
    # a micro-batch: 12 trunk + 12 shared (audio) + 12 shared (text) K1
    implied0 = {"encoder_attention": 36 * len(micro), "conv_tail": 6 * len(micro),
                "decode_attention": 0, "logmel": 0}
    log(f"  attention dropout 0: one update (the first) {time.perf_counter() - t0:.2f} s, loss "
        f"{m['loss']:.2f}, gnorm {m['gnorm']:.4f}; launches {counts0}")
    if counts0 != implied0 or not np.isfinite(m["gnorm"]):
        raise AssertionError(f"train (attention dropout 0): launches {counts0}, want {implied0}")
    rec["launches_attention_dropout_0"] = counts0
    del step
    torch.cuda.empty_cache()
    print(json.dumps({"train": rec}), flush=True)
    return counts, counts0, rec


def w2v2_checkpoint(torch, fx, path: Path) -> Path:
    """A fairseq-layout wav2vec2 ``.pt`` of the fixture model's trunk (the
    base trunk, 12 x 768, 12 heads; weight-normed ``pos_conv``, the
    pretraining heads), as ``--w2v2-model-path`` reads ``wav2vec_small.pt``."""
    from argparse import Namespace

    prefix = "encoder.wav2vec_model."
    sd = {k[len(prefix):]: v for k, v in fairseq_state_dict(torch, fx["model"]).items()
          if k.startswith(prefix)}
    cfg = fx["model"].cfg
    torch.save({"args": Namespace(encoder_embed_dim=cfg.w2v2_embed_dim,
                                  encoder_attention_heads=cfg.w2v2_heads,
                                  conv_feature_layers=W2V_CONV_FEATURE_LAYERS),
                "model": sd}, str(path))
    return path


def train_cli_argv(fx, w2v2: Path, save_dir: Path, max_update: int):
    """The recipe's flags (recipes/train-en2any-ST.sh), then the cuts:
    warm-up 4, micro-batches of 8, 3 an update (one epoch of the 24 wavs),
    bf16, ``max_update`` updates, no epoch files, the 24-wav split as the
    valid subset; each update's results read before the next (``--async-dispatch
    0``), so that its host-clock seconds end with its device work."""
    return [str(fx["root"]), "--task", "triplet", "--config-yaml", "config_wave.yaml",
            "--arch", "s2t_transformer_w2v2_interlingua_base", "--interlingua-length", "64",
            "--w2v2-model-path", str(w2v2), "--w2v2-heads", "12",
            "--criterion", "triplet_st_mt_contrastive", "--label-smoothing", "0.1",
            "--loss-ratio", "1.0", "1.0", "1.0", "--optimizer", "adam",
            "--adam-betas", "(0.9, 0.98)", "--lr", "1e-4", "--lr-scheduler", "inverse_sqrt",
            "--warmup-updates", "4", "--max-tokens", "2000000", "--batch-size", "8",
            "--update-freq", "3", "--max-update", str(max_update), "--save-dir", str(save_dir),
            "--keep-last-epochs", "10", "--best-checkpoint-metric", "st_loss",
            "--dtype", "bfloat16", "--no-epoch-checkpoints", "--train-subset", "train_wave",
            "--valid-subset", "tst_wave", "--async-dispatch", "0"]


def phase_train_cli(torch, fx, work: Path, kernels, train_rec, dist1=None):
    """The train CLI in-process at the recipe's model and settings: run A
    from a fresh start (seeded init, the trunk from a seeded fairseq-layout
    wav2vec2 .pt) to 2 updates, run B resumed from A's checkpoint_last to
    3 (cut from 4 for the script's time limit), then the generate CLI on
    B's checkpoint_best; then ``dist1(w2v2 .pt, run A's (loss, gnorm) list)``,
    where given, whose launches it returns third.

    Launch counts (zeroed before each run, read after): a training
    micro-batch runs K2 6 times and K1 never (attention dropout 0.1 takes
    the plain path); a validation batch runs in eval mode, so K1 on the
    audio pass (12 trunk + 12 shared-encoder layers) and the text pass (12
    shared-encoder layers) = 36, and K2 6; no decoding. The decode of the
    checkpoint: K1 24 and K2 6 a batch, K3 6 a decode step that ran.

    Checks: the counts; run A's checkpoint_last: its optimizer tree read
    back (``Optimizer.read_optax``) equals the trainer's Adam state bit for
    bit; the file restored by the CLI's ``load_state`` into A's trainer on
    the card, its parameters zeroed and its Adam state cleared first, gives
    back the parameters and the Adam state bit for bit; run B starts at step
    2 with the stored iterator state, ends at step 3 with the iterator and best
    metric the JAX rules give; the decode prints one hypothesis per
    utterance. Prints {"train_cli": {...}}; deletes its files."""
    import shutil

    from chimera_st_tpu_torch.checkpoint.store import load_state, read_state
    from chimera_st_tpu_torch.cli import train

    base = work / "train_cli"
    base.mkdir()
    save_dir = base / "checkpoints"
    t0 = time.perf_counter()
    w2v2 = w2v2_checkpoint(torch, fx, base / "wav2vec2_seeded.pt")
    log(f"train_cli: the train CLI at the recipe's operating point, bf16; a seeded "
        f"wav2vec2 .pt of {w2v2.stat().st_size / 1e6:.0f} MB written in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, counts = {}, {}
    for label, max_update in (("A", 2), ("B", 3)):
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        with recorded_updates() as updates:
            out = train.main(train_cli_argv(fx, w2v2, save_dir, max_update))
        torch.cuda.synchronize()
        if label == "A":
            losses_a = updates
        counts[label] = {fn.__name__: fn.launches for fn in kernels}
        runs[label] = out
        t = out["times"]
        micro = 3 * (out["trainer"].num_updates - t["restored"]["step"])
        valid = 3 * len(t["valid_s"])
        implied = {"encoder_attention": 36 * valid, "conv_tail": 6 * micro + 6 * valid,
                   "decode_attention": 0, "logmel": 0}
        log(f"  run {label}: {time.perf_counter() - t0:.1f} s, step {t['restored']['step']} -> "
            f"{out['trainer'].num_updates}, {micro} micro-batches, {valid} validation batches; "
            f"updates {[round(s, 3) for s in t['update_s']]} s, saves "
            f"{[round(s, 2) for s in t['save_s']]} s, validations "
            f"{[round(s, 2) for s in t['valid_s']]} s, load {t['load_s']:.2f} s; launches "
            f"{counts[label]}")
        if counts[label] != implied:
            raise AssertionError(f"train_cli run {label}: launches {counts[label]}, the "
                                 f"micro-batches and validation batches imply {implied}")
        if label == "A":
            trainer = out["trainer"]
            last = save_dir / "checkpoint_last.ckpt"
            size = last.stat().st_size
            held = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
            payload = read_state(str(last))
            named = dict(trainer.model.named_parameters())
            fields, adam_count, count = trainer.optimizer.read_optax(payload["opt_state"],
                                                                     trainer.model)
            state = {"exp_avg": fields["mu"], "exp_avg_sq": fields["nu"]}
            adam = trainer.optimizer.optimizer.state
            same = (adam_count == count == payload["step"] == trainer.num_updates == 2
                    and all(torch.equal(state[k][n], adam[p][k].cpu()) for n, p in named.items()
                            for k in state)
                    and all(int(adam[p]["step"]) == 2 for p in named.values()))
            # the CLI's restore into the same trainer: zeroed parameters and
            # a fresh Adam state first
            adam.clear()
            with torch.no_grad():
                for p in named.values():
                    p.zero_()
            load_state(payload, trainer)
            restored = (all(torch.equal(v, held[k]) for k, v in trainer.model.state_dict().items())
                        and all(torch.equal(state[k][n], adam[p][k].cpu())
                                for n, p in named.items() for k in state)
                        and trainer.num_updates == 2)
            log(f"  checkpoint_last: {size / 1e9:.3f} GB; its optimizer tree read back = the "
                f"trainer's Adam state bit for bit: {same}; parameters and Adam state restored "
                f"through load_state on the card bit for bit: {restored}")
            if not (same and restored):
                raise AssertionError("train_cli: the written checkpoint is not the trainer's state")
            stored_iterator = payload["extra"]["train_iterator"]
            best_a = payload["extra"]["best"]
            del trainer, held, payload, state, adam, named, out
            runs["A"].pop("trainer")
            torch.cuda.empty_cache()
    b = runs["B"]
    payload = read_state(str(save_dir / "checkpoint_last.ckpt"))
    vals = b["times"]["valid"]
    want_best = min([best_a] + vals)
    log(f"  run B: restored at step {b['times']['restored']['step']} with iterator "
        f"{b['times']['restored']['train_iterator']} (stored {stored_iterator}); ended at step "
        f"{payload['step']}, iterator {payload['extra']['train_iterator']}, best "
        f"{payload['extra']['best']:.4f} (run A's {best_a:.4f}, B's validations "
        f"{[round(v, 4) for v in vals]})")
    if (b["times"]["restored"]["step"] != 2 or b["times"]["restored"]["train_iterator"] !=
            stored_iterator or payload["step"] != 3 or b["trainer"].num_updates != 3
            or payload["extra"]["train_iterator"] != {"epoch": 4, "iterations_in_epoch": 0,
                                                     "shuffle": True}
            or payload["extra"]["best"] != want_best):
        raise AssertionError("train_cli: run B did not resume and end as the JAX rules give")
    peak = torch.cuda.max_memory_allocated()
    del b["trainer"], payload
    torch.cuda.empty_cache()

    # the written checkpoint decodes: model_cfg from the file, on the card
    for fn in kernels:
        fn.launches = 0
    with counted_decoder_steps() as steps:
        text, stats, wall = cli_generate(
            fx, base / "decode", "tst_wave", ["--batch-size", str(CLI_BATCH), "--dtype",
                                              "bfloat16"], path=save_dir / "checkpoint_best.ckpt")
        torch.cuda.synchronize()
    counts["decode"] = {fn.__name__: fn.launches for fn in kernels}
    hyps, full, last_line = parse_protocol(text)
    batches = -(-CLI_WAVS // CLI_BATCH)
    implied = {"encoder_attention": 24 * batches, "conv_tail": 6 * batches,
               "decode_attention": 6 * steps[0], "logmel": 0}
    log(f"  decode of checkpoint_best.ckpt: {stats['sentences']} sentences in {wall:.1f} s, "
        f"{steps[0]} decode steps; launches {counts['decode']}; {last_line}")
    if (len(full) != CLI_WAVS or any(len(h) != 1 or not np.isfinite(h[0][0])
                                     for h in hyps.values())
            or counts["decode"] != implied or steps[0] == 0):
        raise AssertionError(f"train_cli decode: {len(full)} samples with all lines, launches "
                             f"{counts['decode']} (want {implied})")
    update_s = runs["A"]["times"]["update_s"][1:] + runs["B"]["times"]["update_s"]
    rec = {"updates_per_s_after_first": len(update_s) / sum(update_s),
           "train_phase_updates_per_s": train_rec["updates_per_s"],
           "update_s": {k: r["times"]["update_s"] for k, r in runs.items()},
           "save_s": {k: r["times"]["save_s"] for k, r in runs.items()},
           "checkpoint_bytes": size, "resume_load_s": runs["B"]["times"]["load_s"],
           "valid_s": {k: r["times"]["valid_s"] for k, r in runs.items()},
           "peak_memory_gb": peak / 1e9, "decode_s": stats["decode_s"],
           "decode_load_s": stats["load_s"], "launches": counts}
    log(f"  updates/s through the CLI after its first update {rec['updates_per_s_after_first']:.3f}"
        f" (the train phase, from Python: {train_rec['updates_per_s']:.3f}); a checkpoint "
        f"{size / 1e9:.2f} GB written in {rec['save_s']}; resume load "
        f"{rec['resume_load_s']:.2f} s; peak memory {peak / 1e9:.2f} GB")
    print(json.dumps({"train_cli": rec}), flush=True)
    dist1_counts = dist1(w2v2, losses_a) if dist1 is not None else {}
    shutil.rmtree(base)
    train_counts = {k: counts["A"][k] + counts["B"][k] for k in counts["A"]}
    return train_counts, counts["decode"], dist1_counts


# ---- the MT stage: the translation task at the recipe's operating point
# (recipes/train-en2any-MT.sh), on seeded parallel text binarized by the
# port's preprocess CLI

MT_VOCAB = 40000  # the recipe's --subword-tokens 40000 (prepare-wmt-en2any.sh)
MT_TRAIN_PAIRS = 880  # about 2 updates an epoch at --max-tokens 4096 --update-freq 8
MT_EVAL_PAIRS = 128
MT_LENGTHS = (4, 120)
MT_MODEL = {"arch": "s2t_transformer_w2v2_interlingua_base", "interlingua_length": 64}
MT_CRITERION = {"_name": "label_smoothed_cross_entropy", "label_smoothing": 0.1}
MT_DECODE_BATCH = 32
MT_MAX_TOKENS = 4096  # the recipe's --max-tokens


def make_mt_fixture(root: Path, seed: int = 13) -> dict:
    """Seeded parallel text (en -> de) and a joined dictionary of MT_VOCAB
    subwords, binarized by the port's preprocess CLI (``--joined-dictionary
    --srcdict``): source lengths uniform in MT_LENGTHS, symbols drawn from a
    Zipf law (exponent 1.1) over the vocabulary, each target within +-20 %
    of its source's length; MT_TRAIN_PAIRS training pairs, MT_EVAL_PAIRS each
    for valid and test."""
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(seed)
    n_words = MT_VOCAB - 4  # + bos, pad, eos, unk
    words = np.asarray([f"s{i}" for i in range(n_words)])
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    raw = root / "raw"
    raw.mkdir(parents=True)
    counts = np.zeros(n_words, np.int64)
    n_tokens = {}
    for split, n in (("train", MT_TRAIN_PAIRS), ("valid", MT_EVAL_PAIRS),
                     ("test", MT_EVAL_PAIRS)):
        src_len = rng.integers(MT_LENGTHS[0], MT_LENGTHS[1] + 1, n)
        tgt_len = np.maximum(1, np.rint(src_len * rng.uniform(0.8, 1.2, n))).astype(int)
        for lang, lengths in (("en", src_len), ("de", tgt_len)):
            ids = rng.choice(n_words, size=int(lengths.sum()), p=p)
            counts += np.bincount(ids, minlength=n_words)
            rows = np.split(words[ids], np.cumsum(lengths)[:-1])
            (raw / f"{split}.{lang}").write_text("".join(" ".join(r) + "\n" for r in rows))
            n_tokens[(split, lang)] = int(lengths.sum())
    dict_file = root / "dict.txt"
    dict_file.write_text("".join(f"{w} {c}\n" for w, c in zip(words, np.maximum(counts, 1))))
    bin_dir = root / "bin"
    t0 = time.perf_counter()
    preprocess.main(["-s", "en", "-t", "de", "--joined-dictionary", "--srcdict", str(dict_file),
                     "--trainpref", str(raw / "train"), "--validpref", str(raw / "valid"),
                     "--testpref", str(raw / "test"), "--destdir", str(bin_dir)])
    log(f"mt fixture: {MT_TRAIN_PAIRS} training pairs ({n_tokens[('train', 'en')]} source, "
        f"{n_tokens[('train', 'de')]} target subwords), {MT_EVAL_PAIRS} valid and test pairs, "
        f"a joined dictionary of {MT_VOCAB}; binarized in {time.perf_counter() - t0:.1f} s")
    return dict(root=root, bin=bin_dir, raw=raw)


def mt_task(fx):
    from chimera_st_tpu_torch.tasks import setup_task

    return setup_task({"_name": "translation", "data": str(fx["bin"]), "source_lang": "en",
                       "target_lang": "de"})


def phase_mt_parity(torch, fx):
    """One text-only update of the MT model at full width in fp32 (TF32
    off), every dropout 0, 2 micro-batches of 8 binarized pairs (the longest
    of the split), the audio trunk masked out of Adam as the train CLI masks
    it: on the card (K1 through its Function) and on the CPU. Gates of
    train_parity: loss and nll_loss 1e-5, gnorm 1e-3 (relative), every
    trained gradient 1e-2 (L2 per tensor), the Adam update within lr *
    min(2, |dg| / eps). The trunk bit-identical to its start on both
    devices and without Adam state; the optimizer tree, pickled and read
    back, has the JAX trainer's masked layout (``Optimizer.read_optax``
    checks structure and shapes)."""
    import itertools
    import pickle

    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.optim.freeze import auto_text_only_fixes, wrap_freeze
    from chimera_st_tpu_torch.train import TrainStep

    task = mt_task(fx)
    micro = list(itertools.islice(task.make_batch_iterator(
        task.dataset("train"), max_sentences=8).next_epoch_itr(shuffle=False), 2))
    log(f"mt_parity: fp32, every dropout 0, 2 micro-batches of 8 pairs (source / target padded "
        f"to {[b['src_tokens'].shape[1] for b in micro]} / "
        f"{[b['target'].shape[1] for b in micro]}), card vs CPU, one Adam update at lr 1e-4")
    out = {}
    for device in ("cuda", "cpu"):
        model = drawn_on_card(torch, task.build_model(
            dict(MT_MODEL, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0),
            device="cuda", train=True), 17).to(device)
        fixes = auto_text_only_fixes(task, model)
        trained, frozen = wrap_freeze(model, fixes)
        opt = build_optimizer({"_name": "adam", "adam_betas": "(0.9, 0.98)"}, trained,
                              frozen=frozen)
        step = TrainStep(model, task.build_criterion(MT_CRITERION), opt,
                         build_lr_schedule({"_name": "fixed", "lr": 1e-4}),
                         compute_dtype=torch.float32)
        frozen_names = {n for n, p in model.named_parameters() if any(p is f for f in frozen)}
        before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        t0 = time.perf_counter()
        metrics = step(micro)
        log(f"  {device}: {time.perf_counter() - t0:.2f} s, loss {metrics['loss']:.4f}, gnorm "
            f"{metrics['gnorm']:.4f}; {fixes}: {len(frozen_names)} of {len(before)} tensors "
            f"({sum(before[n].numel() for n in frozen_names) / 1e6:.1f} M parameters) masked")
        no_state = all(p not in opt.optimizer.state for p in frozen) and all(
            p in opt.optimizer.state for p in trained)
        tree = pickle.loads(pickle.dumps(opt.state_to_optax(model, step.num_updates)))
        opt.read_optax(tree, model)  # raises on another layout
        mu = tree["inner_states"]["train"]["inner_state"]["0"]["mu"]["params"]
        if fixes != ("fix_audio_trunk",) or not no_state or mu["wav2vec_model"] \
                ["post_extract_proj"]["kernel"] != {} or tree["inner_states"]["freeze"] != \
                {"inner_state": {}}:
            raise AssertionError(f"mt_parity ({device}): the trunk is not masked out of Adam "
                                 f"as the JAX trainer masks it ({fixes})")
        out[device] = (metrics, before, frozen_names,
                       {k: p.grad.cpu() for k, p in model.named_parameters()},
                       {k: p.detach().cpu() for k, p in model.named_parameters()})
        del model, step, opt
    (mg, before, frozen, gg, pg), (mc, _, _, gc, pc) = out["cuda"], out["cpu"]
    trained = [k for k in gc if k not in frozen]
    trunk_same = all(torch.equal(pg[k], before[k]) and torch.equal(pc[k], before[k])
                     for k in frozen)
    log(f"  the {len(frozen)} trunk tensors bit-identical to their start on both devices: "
        f"{trunk_same}")
    if not trunk_same:
        raise AssertionError("mt_parity: the masked trunk moved")
    compare_step(torch, "mt", (mg, gg, pg), (mc, gc, pc), before, names=trained)
    torch.cuda.empty_cache()


def mt_train_argv(fx, save_dir: Path, max_epoch: int):
    """recipes/train-en2any-MT.sh:13-24 (TGT de), then the cut: warm-up 4
    (recipe 4,000), so that parameters move; ``max_epoch`` epochs."""
    return [str(fx["bin"]), "--task", "translation", "-s", "en", "-t", "de",
            "--arch", "s2t_transformer_w2v2_interlingua_base", "--interlingua-length", "64",
            "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--clip-norm", "0.0",
            "--lr", "5e-4", "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4",
            "--max-tokens", str(MT_MAX_TOKENS), "--update-freq", "8", "--max-update", "500000",
            "--save-dir", str(save_dir), "--keep-last-epochs", "10",
            "--best-checkpoint-metric", "loss", "--max-epoch", str(max_epoch)]


def phase_mt_cli(torch, fx, work: Path, kernels, enc_attn, conv_tail, dec_attn,
                 profile=False):
    """The MT stage through the entry points, in-process, at the recipe's
    model (full width and depth, interlingua length 64) and flags, bf16:
    run A from a fresh start to 2 epochs, run B resumed from A's
    checkpoint_last to epoch 3, the averaging tool over the three epoch
    files, then the generate CLI on the test split of the averaged file
    (beam 5, max decode length 64, batches of 32, bf16).

    Launch counts (zeroed before each run, read after): a training
    micro-batch none (attention dropout 0.1 takes the plain path; the text
    branch runs no trunk, so no K2, no K4); a validation batch, in eval
    mode, K1 12 (the 12 shared-encoder layers on text); the decode K1 12 a
    batch and K3 6 a decoder step that ran (64 a batch unless every
    hypothesis of the batch ended before: beam search stops there). Checks: the counts; A's
    checkpoint_last's optimizer tree read back equals the trainer's Adam
    state bit for bit (the trunk without moments), and the file restored by
    the CLI's load_state into the trainer, zeroed first, gives back its
    parameters and Adam state; B starts at A's step and
    iterator and ends an epoch later with the iterator and best metric of
    the JAX rules; the averaged parameters are the fp64 mean of the three
    files cast to fp32; the decode prints one hypothesis a test pair.
    Returns ({"mt_cli": launches of A + B, "mt_cli_decode": ...}, the K1
    and K3 shapes seen); prints the record as {"mt_cli": {...}}; deletes
    its files."""
    import pickle
    import shutil

    from chimera_st_tpu_torch.checkpoint.store import load_state, read_state
    from chimera_st_tpu_torch.cli import generate, train
    from chimera_st_tpu_torch.tools import average_checkpoints

    task = mt_task(fx)
    n_train = len(task.make_batch_iterator(task.dataset("train"), max_tokens=MT_MAX_TOKENS))
    n_valid = len(task.make_batch_iterator(task.dataset("valid"), max_tokens=MT_MAX_TOKENS))
    per_epoch = -(-n_train // 8)
    src_tokens = int(task.dataset("train").src_sizes.sum())
    tgt_tokens = int(task.dataset("train").tgt_sizes.sum())
    log(f"mt_cli: the train CLI at recipes/train-en2any-MT.sh's operating point, bf16: "
        f"{n_train} micro-batches of at most {MT_MAX_TOKENS} tokens an epoch, {per_epoch} "
        "updates; "
        f"{n_valid} validation batches")
    base = work / "mt_cli"
    save_dir = base / "checkpoints"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, counts = {}, {}
    layers = {}  # the model's shared-encoder and decoder layers
    with recorded_shapes(enc_attn, conv_tail, dec_attn) as seen:
        for label, max_epoch in (("A", 2), ("B", 3)):
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            with counted_decoder_steps() as steps:
                out = train.main(mt_train_argv(fx, save_dir, max_epoch))
            torch.cuda.synchronize()
            counts[label] = {fn.__name__: fn.launches for fn in kernels}
            runs[label] = out
            t = out["times"]
            cfg = out["trainer"].model.cfg
            layers = {"encoder": cfg.encoder_layers, "decoder": cfg.decoder_layers}
            implied = {"encoder_attention": layers["encoder"] * n_valid * len(t["valid_s"]),
                       "conv_tail": 0, "decode_attention": 0, "logmel": 0}
            log(f"  run {label}: {time.perf_counter() - t0:.1f} s, step {t['restored']['step']} "
                f"-> {out['trainer'].num_updates}; epochs {[round(s, 2) for s in t['epoch_s']]} s "
                f"for {t['epoch_updates']} updates; saves {[round(s, 2) for s in t['save_s']]} s, "
                f"validations {[round(s, 2) for s in t['valid_s']]} s, load {t['load_s']:.2f} s; "
                f"launches {counts[label]}")
            if counts[label] != implied or steps[0] or t["epoch_updates"] != \
                    [per_epoch] * len(t["epoch_updates"]):
                raise AssertionError(f"mt_cli run {label}: launches {counts[label]} (want "
                                     f"{implied}), {steps[0]} decoder steps, updates an epoch "
                                     f"{t['epoch_updates']} (want {per_epoch})")
            if label == "A":
                trainer = out["trainer"]
                last = save_dir / "checkpoint_last.ckpt"
                size = last.stat().st_size
                payload = read_state(str(last))
                named = dict(trainer.model.named_parameters())
                frozen = {n for n, p in named.items()
                          if any(p is f for f in trainer.optimizer.frozen)}
                held = {n: p.detach().clone() for n, p in named.items()}
                fields, adam_count, count = trainer.optimizer.read_optax(payload["opt_state"],
                                                                         trainer.model)
                state = {"exp_avg": fields["mu"], "exp_avg_sq": fields["nu"]}
                adam = trainer.optimizer.optimizer.state
                same = (adam_count == count == payload["step"] == trainer.num_updates
                        == 2 * per_epoch
                        and all(set(state[k]) == set(named) - frozen for k in state)
                        and all(torch.equal(state[k][n], adam[p][k].cpu()) for n, p in
                                named.items() if n not in frozen for k in state))
                adam.clear()
                with torch.no_grad():
                    for p in named.values():
                        p.zero_()
                load_state(payload, trainer)
                restored = trainer.num_updates == 2 * per_epoch and all(
                    torch.equal(p, held[n]) for n, p in named.items()) and all(
                    torch.equal(state[k][n], adam[p][k].cpu()) for n, p in named.items()
                    if n not in frozen for k in state) and not any(
                    p in adam for n, p in named.items() if n in frozen)
                n_all = sum(p.numel() for p in named.values())
                n_trained = sum(p.numel() for n, p in named.items() if n not in frozen)
                log(f"  checkpoint_last: {size / 1e9:.3f} GB ({n_all / 1e6:.1f} M parameters, "
                    f"{n_trained / 1e6:.1f} M of them with Adam moments; the same tree unmasked "
                    f"would hold {12 * n_all / 1e9:.3f} GB of fp32 leaves, masked "
                    f"{(4 * n_all + 8 * n_trained) / 1e9:.3f} GB); its optimizer tree read back "
                    f"= the trainer's Adam state bit for bit: {same}; parameters and Adam state "
                    f"restored through load_state into zeroed parameters: {restored}")
                if not (same and restored):
                    raise AssertionError("mt_cli: the written checkpoint is not the trainer's "
                                         "state")
                stored_iterator = payload["extra"]["train_iterator"]
                best_a = payload["extra"]["best"]
                del trainer, held, payload, state, adam, named, out
                runs["A"].pop("trainer")
                torch.cuda.empty_cache()
        b = runs["B"]
        payload = read_state(str(save_dir / "checkpoint_last.ckpt"))
        vals = b["times"]["valid"]
        log(f"  run B: restored at step {b['times']['restored']['step']} with iterator "
            f"{b['times']['restored']['train_iterator']} (stored {stored_iterator}); ended at "
            f"step {payload['step']}, iterator {payload['extra']['train_iterator']}, best "
            f"{payload['extra']['best']:.4f} (run A's {best_a:.4f}, B's validation "
            f"{[round(v, 4) for v in vals]})")
        if (b["times"]["restored"]["step"] != 2 * per_epoch
                or b["times"]["restored"]["train_iterator"] != stored_iterator
                or payload["step"] != 3 * per_epoch or b["trainer"].num_updates != 3 * per_epoch
                or payload["extra"]["train_iterator"] != {"epoch": 4, "iterations_in_epoch": 0,
                                                         "shuffle": True}
                or payload["extra"]["best"] != min([best_a] + vals)):
            raise AssertionError("mt_cli: run B did not resume and end as the JAX rules give")
        peak = torch.cuda.max_memory_allocated()
        if profile:
            import itertools

            micro = list(itertools.islice(task.make_batch_iterator(
                task.dataset("train"), max_tokens=MT_MAX_TOKENS).next_epoch_itr(shuffle=False),
                8))
            prof = train_profile(torch, b["trainer"].step, micro)
        del b["trainer"], payload
        torch.cuda.empty_cache()

        # the averaging tool over the three epoch files
        epochs = [save_dir / f"checkpoint{e}.ckpt" for e in (1, 2, 3)]
        avg = base / "averaged.ckpt"
        t0 = time.perf_counter()
        average_checkpoints.main(["--inputs", *map(str, epochs), "--output", str(avg)])
        avg_s = time.perf_counter() - t0
        def leaf(path):
            with open(path, "rb") as f:
                node = pickle.load(f)["params"]
            for k in ("params", "decoder", "layer_norm", "scale"):
                node = node[k]
            return np.asarray(node)

        parts = [leaf(p) for p in epochs]
        if not np.array_equal(leaf(avg), ((parts[0].astype(np.float64) + parts[1] + parts[2])
                                          / 3).astype(np.float32)):
            raise AssertionError("mt_cli: the averaged parameters are not the fp64 mean")
        log(f"  averaged {len(epochs)} epoch files of {epochs[0].stat().st_size / 1e9:.2f} GB in "
            f"{avg_s:.1f} s")

        # the generate CLI on the averaged file
        for fn in kernels:
            fn.launches = 0
        out_dir = base / "decode"
        out_dir.mkdir()
        with counted_decoder_steps() as steps:
            t0 = time.perf_counter()
            stats = generate.main([str(fx["bin"]), "--task", "translation", "--path", str(avg),
                                   "--gen-subset", "test", "--beam", "5", "--max-decode-len",
                                   "64", "--batch-size", str(MT_DECODE_BATCH), "--dtype",
                                   "bfloat16", "--scoring", "bleu", "--results-path",
                                   str(out_dir)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts["decode"] = {fn.__name__: fn.launches for fn in kernels}
    hyps, full, last_line = parse_protocol((out_dir / "generate-test.txt").read_text())
    batches = -(-MT_EVAL_PAIRS // MT_DECODE_BATCH)
    implied = {"encoder_attention": layers["encoder"] * batches, "conv_tail": 0,
               "decode_attention": layers["decoder"] * steps[0], "logmel": 0}
    log(f"  decode of the averaged file: {stats['sentences']} sentences in {wall:.1f} s "
        f"(decode {stats['decode_s']:.2f} s, {stats['sentences'] / stats['decode_s']:.1f} "
        f"sentences/s; load {stats['load_s']:.2f} s), {steps[0]} decoder steps for {batches} "
        f"batches ({64 * batches} if no hypothesis ended early); launches {counts['decode']}; "
        f"{last_line}")
    if (len(full) != MT_EVAL_PAIRS or any(len(h) != 1 or not np.isfinite(h[0][0])
                                          for h in hyps.values())
            or counts["decode"] != implied or steps[0] == 0):
        raise AssertionError(f"mt_cli decode: {len(full)} samples with all lines, launches "
                             f"{counts['decode']} (want {implied})")
    epoch_s = runs["A"]["times"]["epoch_s"] + runs["B"]["times"]["epoch_s"]
    # the rates after the first update: run A's second epoch, every update of
    # which follows the run's first (an epoch's seconds end with its device
    # work; run B's one epoch holds the resumed trainer's first update)
    after_first_s = runs["A"]["times"]["epoch_s"][1]
    rec = {"updates_per_epoch": per_epoch, "micro_batches_per_epoch": n_train,
           "epoch_s": epoch_s,
           "updates_per_s_after_first": per_epoch / after_first_s,
           "source_tokens_per_s_after_first": src_tokens / after_first_s,
           "target_tokens_per_s_after_first": tgt_tokens / after_first_s,
           "update_s": {k: r["times"]["update_s"] for k, r in runs.items()},
           "save_s": {k: r["times"]["save_s"] for k, r in runs.items()},
           "checkpoint_bytes": size, "resume_load_s": runs["B"]["times"]["load_s"],
           "valid_s": {k: r["times"]["valid_s"] for k, r in runs.items()},
           "peak_memory_gb": peak / 1e9, "average_s": avg_s, "decode_s": stats["decode_s"],
           "decode_load_s": stats["load_s"], "decoder_steps": steps[0],
           "sentences_per_s": stats["sentences"] / stats["decode_s"], "launches": counts}
    if profile:
        rec["profile"] = prof
    log(f"  after the first update (run A's epoch 2): "
        f"{rec['updates_per_s_after_first']:.3f} updates/s, "
        f"{rec['source_tokens_per_s_after_first']:.0f} source / "
        f"{rec['target_tokens_per_s_after_first']:.0f} target tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    shutil.rmtree(base)
    print(json.dumps({"mt_cli": rec}), flush=True)
    train_counts = {k: counts["A"][k] + counts["B"][k] for k in counts["A"]}
    return {"mt_cli": train_counts, "mt_cli_decode": counts["decode"]}, seen


def phase_shapes(torch, ops, seen, records, prefix, expect, timed=()):
    """Every shape at which a group of phases launched K1, K2 and K3 (``seen``
    from recorded_shapes), held against the plain version as phase 3 holds
    them: K1 and K2 in bf16 and fp32, K3 at the first, middle and last step
    of the shape's cache (0, 31 and 63 of 64) in bf16 and fp32 with the
    cache writes bit-equal; times and bounds too of the kernels named in
    ``timed``. ``expect(shapes)`` says what the phases
    must have launched. The records go into each kernel's ``shapes``, K3's
    main numbers those of its last step."""
    t0 = time.perf_counter()
    enc_attn, conv_tail, dec_attn = ops
    shapes = {name: list(dict.fromkeys(shape for shape, _ in pairs))
              for name, pairs in seen.items()}
    dtypes = {name: sorted({str(d).replace("torch.", "") for _, d in pairs})
              for name, pairs in seen.items()}
    log(f"{prefix}_shapes: the phases launched K1 at {len(shapes['encoder_attention'])} shapes "
        f"(B, T, H, D) {shapes['encoder_attention']}, K2 at {len(shapes['conv_tail'])} (B, T1, "
        f"C) {shapes['conv_tail']}, K3 at {len(shapes['decode_attention'])} (N, H, L, D, beam) "
        f"{shapes['decode_attention']}; in {dtypes}")
    if not expect(shapes):
        raise AssertionError(f"{prefix}_shapes: not the launches the phases make: {shapes}")
    tensor = Inputs(torch, 4)
    rec = {r["name"]: r for r in records}
    for B, T, H, D in shapes["encoder_attention"]:
        label = f"{prefix}_B{B}_T{T}_H{H}_D{D}"
        rec["encoder_attention"]["shapes"][label] = k1_case(torch, enc_attn, tensor, label, B, T,
                                                            H, D,
                                                            timed="encoder_attention" in timed)
    for B, T1, _ in shapes["conv_tail"]:
        rec["conv_tail"]["shapes"][f"{prefix}_B{B}_T1_{T1}"] = k2_case(
            torch, conv_tail, tensor, B, T1, timed="conv_tail" in timed)
    rng = np.random.default_rng(7)
    for N, H, L, D, C in shapes["decode_attention"]:
        label = f"{prefix}_S{N // C}_C{C}_H{H}_D{D}"
        inputs = k3_inputs(torch, tensor, rng, N // C, C, H, L, D)
        last, mid = L - 1, L // 2 - 1  # 63 and 31 of a 64-step cache
        steps = {idx: k3_step(torch, dec_attn, inputs, label, C, idx,
                              timed="decode_attention" in timed)
                 for idx in (last, mid, 0)}
        rec["decode_attention"].setdefault("shapes", {})[f"{label}_L{L}"] = dict(
            steps[last], steps={"0": steps[0], str(mid): steps[mid]})
    log(f"{prefix}_shapes: {sum(map(len, shapes.values()))} shapes held in "
        f"{time.perf_counter() - t0:.1f} s")


def parse_protocol(text: str):
    """-> ({sample id: [(score, hypothesis), ...]} from the H- lines, the ids
    that have all of S-/H-/D-/P-, the last line)."""
    hyps, kinds = {}, {}
    for line in text.splitlines():
        head, _, rest = line.partition("\t")
        if len(head) > 2 and head[1] == "-" and head[0] in "STHDPW" and head[2:].isdigit():
            sid = int(head[2:])
            kinds.setdefault(sid, set()).add(head[0])
            if head[0] == "H":
                score, _, hyp = rest.partition("\t")
                hyps.setdefault(sid, []).append((float(score), hyp))
    full = {sid for sid, k in kinds.items() if {"S", "H", "D", "P"} <= k}
    return hyps, full, (text.strip().splitlines() or [""])[-1]


def cli_generate(fx, out_dir: Path, subset: str, extra, path=None):
    """The port's generate CLI on the fixture (the seeded ``.pt`` unless
    ``path``) -> (its output file's text, its returned counts and times, the
    wall seconds of the whole call)."""
    from chimera_st_tpu_torch.cli import generate

    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    stats = generate.main([
        str(fx["root"]), "--task", "triplet", "--path", str(path or fx["ckpt"]),
        "--gen-subset", subset,
        "--beam", "10", "--lenpen", "1.5", "--max-decode-len", "64", "--scoring", "bleu",
        "--results-path", str(out_dir), *extra])
    return ((out_dir / f"generate-{subset}.txt").read_text(), stats,
            time.perf_counter() - t0)


def same_hypotheses(label, got, want, n_ids):
    """Best hypotheses identical as strings, scores within 1e-4."""
    if sorted(got) != sorted(want) or len(got) != n_ids:
        raise AssertionError(f"{label}: sample ids {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for sid, ((score, hyp), *_) in got.items():
        want_score, want_hyp = want[sid][0]
        if hyp != want_hyp:
            raise AssertionError(f"{label}: sample {sid} differs:\n  {hyp}\n  {want_hyp}")
        worst = max(worst, abs(score - want_score))
    # both scores are printed with four decimals: allow the rounding of each
    check(f"{label}: {n_ids} best hypotheses identical as strings; scores", worst, 1e-4 + 1e-4)


def phase_checkpoint(torch, fx):
    """The fairseq-layout checkpoint read back through the CLI's loader is
    the seeded model: every tensor equal (the folded weight norm to 1e-6)."""
    from chimera_st_tpu_torch.cli.generate import load_model_and_params
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "triplet", "data": str(fx["root"]),
                       "config_yaml": "config_wave.yaml"})
    t0 = time.perf_counter()
    model = load_model_and_params(str(fx["ckpt"]), task, torch.float32, "cuda")
    load_s = time.perf_counter() - t0
    if model.cfg != fx["model"].cfg:
        raise AssertionError(f"config inferred from the checkpoint: {model.cfg}")
    want = fx["model"].state_dict()
    got = {k: v.cpu() for k, v in model.state_dict().items()}
    if sorted(got) != sorted(want):
        raise AssertionError("the loaded model's tensors are not the seeded model's")
    worst = max(max_err(got[k], want[k]) for k in want)
    check(f"checkpoint: .pt -> importer -> model on the card in {load_s:.1f} s, "
          f"{len(want)} tensors vs the seeded model", worst, 1e-6)
    return task, model


def phase_cli_parity(torch, fx, work: Path):
    """fp32: the generate CLI on the card (kernels) and with --device cpu
    (plain versions), the same arguments otherwise."""
    log(f"cli_parity: generate CLI, fp32, {CLI_WAVS} wavs in batches of {CLI_BATCH}, beam 10, "
        "card vs --device cpu")
    common = ["--batch-size", str(CLI_BATCH), "--dtype", "float32", *PARITY_DECODE]
    gpu_text, _, gpu_s = cli_generate(fx, work / "parity_cuda", "tst_wave", common)
    cpu_text, _, cpu_s = cli_generate(fx, work / "parity_cpu", "tst_wave",
                                      common + ["--device", "cpu"])
    log(f"  card {gpu_s:.1f} s, CPU {cpu_s:.1f} s")
    (gh, gfull, glast), (ch, cfull, clast) = parse_protocol(gpu_text), parse_protocol(cpu_text)
    if len(gfull) != CLI_WAVS or len(cfull) != CLI_WAVS:
        raise AssertionError(f"samples with S-/H-/D-/P- lines: card {len(gfull)}, CPU "
                             f"{len(cfull)}, expected {CLI_WAVS}")
    same_hypotheses("cli_parity", gh, ch, CLI_WAVS)
    if glast != clast or not glast.startswith("Generate tst_wave with beam=10: BLEU4 = "):
        raise AssertionError(f"corpus score lines differ:\n  {glast}\n  {clast}")
    log(f"  {glast}")


def phase_cli_serve(torch, fx, work: Path, kernels, profile=False):
    """bf16: the README's operating point through the generate CLI, full
    width, depth not cut; launch counts zeroed just before and read just
    after. Returns the counts."""
    from chimera_st_tpu_torch.tasks import setup_task

    log(f"cli_serve: generate CLI, bf16, {CLI_WAVS} wavs in batches of {CLI_BATCH}, beam 10, "
        "lenpen 1.5")
    serve_args = ["--batch-size", str(CLI_BATCH), "--dtype", "bfloat16"]
    for fn in kernels:
        fn.launches = 0
    with counted_decoder_steps() as steps:
        text, stats, wall = cli_generate(fx, work / "serve", "tst_wave", serve_args)
        torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in kernels}
    hyps, full, last = parse_protocol(text)
    if len(full) != CLI_WAVS or stats["sentences"] != CLI_WAVS:
        raise AssertionError(f"cli_serve translated {stats['sentences']} sentences, "
                             f"{len(full)} with all lines")
    for sid, ((score, hyp), *_) in hyps.items():
        if not np.isfinite(score) or not hyp:
            raise AssertionError(f"cli_serve: sample {sid}: score {score}, hypothesis {hyp!r}")
    batches = -(-CLI_WAVS // CLI_BATCH)
    # per batch: 12 trunk + 12 shared encoder layers, 6 conv-tail layers; per
    # decode step that ran: 6 decoder layers
    implied = {"encoder_attention": 24 * batches, "conv_tail": 6 * batches,
               "decode_attention": 6 * steps[0], "logmel": 0}
    log(f"  {batches} batches, {steps[0]} decode steps; launches {counts}")
    if counts != implied or steps[0] == 0:
        raise AssertionError(f"cli_serve launches {counts}, the batches imply {implied}")
    # the host's share that is the data layer: the same batches read and
    # collated with no model behind them (the CLI overlaps it on a thread)
    task = setup_task({"_name": "triplet", "data": str(fx["root"]),
                       "config_yaml": "config_wave.yaml"})
    t0 = time.perf_counter()
    n_read = sum(b["nsentences"] for b in task.make_batch_iterator(
        task.dataset("tst_wave"), max_sentences=CLI_BATCH).next_epoch_itr(shuffle=False))
    data_s = time.perf_counter() - t0
    if n_read != CLI_WAVS:
        raise AssertionError(f"the batch iterator yielded {n_read} sentences")
    rec = {"sentences": stats["sentences"], "wall_s": wall,
           "sentences_per_s": stats["sentences"] / stats["decode_s"],
           "load_s": stats["load_s"], "decode_s": stats["decode_s"], "data_s": data_s,
           "decode_steps": steps[0], "launches": counts}
    log(f"  {last}")
    log(f"  wall {wall:.2f} s = load {stats['load_s']:.2f} + batches {stats['decode_s']:.2f} + "
        f"set-up {wall - stats['load_s'] - stats['decode_s']:.2f}; reading and collating the "
        f"{batches} batches alone takes {data_s:.3f} s")
    if profile:
        _, pstats, _ = cli_generate(fx, work / "serve_profiled", "tst_wave",
                                    [*serve_args, "--profile", str(work / "serve_trace")])
        rec["profiled"] = dict(trace_busy(work / "serve_trace" / "trace.json"),
                               decode_s=pstats["decode_s"], load_s=pstats["load_s"])
        log(f"  under --profile: batches {pstats['decode_s']:.2f} s, device busy "
            f"{rec['profiled']['device_busy_ms'] / 1e3:.3f} s = "
            f"{100 * rec['profiled']['busy_share']:.1f} % of the trace's "
            f"{rec['profiled']['wall_ms'] / 1e3:.2f} s")
    print(json.dumps({"cli": rec}), flush=True)
    return counts


def phase_interactive(torch, fx, work: Path):
    """The interactive CLI on a file of 4 wav paths, 2 a buffer, against the
    generate CLI on a manifest of the same wavs in batches of 2 (both pad a
    pair to its longer wav), fp32 on the card."""
    import contextlib
    import io

    from chimera_st_tpu_torch.cli import interactive

    log("interactive: 4 wav paths from a file, --buffer-size 2, fp32, vs the generate CLI")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        interactive.main([
            str(fx["root"]), "--task", "triplet", "--path", str(fx["ckpt"]), "--beam", "10",
            "--lenpen", "1.5", "--max-decode-len", "64", "--dtype", "float32",
            "--input", str(fx["root"] / "pairs.txt"), "--buffer-size", "2"])
    got, full, _ = parse_protocol(buf.getvalue())
    if len(full) != 4 or buf.getvalue().count("\nW-") + buf.getvalue().startswith("W-") != 4:
        raise AssertionError(f"interactive output:\n{buf.getvalue()[:2000]}")
    text, _, _ = cli_generate(fx, work / "pairs", "pairs",
                              ["--batch-size", "2", "--dtype", "float32"])
    want, _, _ = parse_protocol(text)
    # the manifest's rows are longest first, as the input file: ids 0..3 agree
    same_hypotheses("interactive vs generate", got, want, 4)


def phase_text(torch, fx, task, kernels):
    """generate_text on the card (K1 at text shapes, K3) vs the CPU, fp32:
    8 source sentences of the manifest, padded to a multiple of 16."""
    from chimera_st_tpu_torch.data.batching import collate_tokens, round16
    from chimera_st_tpu_torch.data.manifests import load_tsv
    from chimera_st_tpu_torch.cli.generate import load_model_and_params
    from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator

    d = task.source_dictionary
    rows = load_tsv(str(fx["root"] / "tst_wave.tsv"))[:8]
    encoded = [d.encode_line(r["src_text"]) for r in rows]
    src = collate_tokens(encoded, d.pad(), target_len=round16(max(len(e) for e in encoded)))
    lengths = np.asarray([len(e) for e in encoded], np.int64)
    log(f"text: generate_text, fp32, 8 sentences of {lengths.min()}..{lengths.max()} tokens "
        f"padded to {src.shape[1]}, beam 10, card vs CPU")
    settings = GeneratorSettings(beam_size=10, max_decode_len=64, len_penalty=1.5, min_len=10)
    out, counts = {}, {}
    for device in ("cuda", "cpu"):
        model = load_model_and_params(str(fx["ckpt"]), task, torch.float32, device)
        gen = SequenceGenerator(model, settings, pad=d.pad(), eos=d.eos(), unk=d.unk())
        for fn in kernels:
            fn.launches = 0
        with counted_decoder_steps() as steps:
            toks, scores, lens = gen.generate_text(
                torch.from_numpy(src).long().to(device), torch.from_numpy(lengths).to(device))
        if device == "cuda":
            card_steps = steps[0]
            torch.cuda.synchronize()
            counts = {fn.__name__: fn.launches for fn in kernels}
        elif any(fn.launches for fn in kernels):
            raise AssertionError("a kernel was launched for CPU tensors")
        out[device] = [t.cpu() for t in (toks, scores, lens)]
        del model, gen
    (tg, sg, lg), (tc, sc, lc) = out["cuda"], out["cpu"]
    if not torch.equal(tg[:, 0], tc[:, 0]) or not torch.equal(lg[:, 0], lc[:, 0]):
        raise AssertionError("text: best hypotheses differ between the card and the CPU")
    log(f"  best hypotheses token-identical; lengths {lg[:, 0].tolist()}")
    check("text: best scores, card vs CPU", max_err(sg[:, 0], sc[:, 0]), 1e-4)
    log(f"  {card_steps} decode steps; launches {counts}")
    # 12 shared encoder layers once; 6 decoder layers a step that ran; no
    # audio kernels
    implied = {"encoder_attention": 12, "conv_tail": 0, "decode_attention": 6 * card_steps,
               "logmel": 0}
    if counts != implied or card_steps == 0:
        raise AssertionError(f"text path launches {counts}, the batch implies {implied}")
    return counts


# ---- the search surface: every generation mode of the flagship on one
# batch, card vs CPU in fp32 with K3 held in place at each mode's ancestries,
# then each mode timed in bf16 with exact launch counts

SEARCH_BATCH = 2  # cut from 8 for the script's time limit
SEARCH_REPS = 2  # bf16 rounds: every mode timed in the first (cut from 2 for the
# script's time limit), retained dropout in both (its same-seed check)
# per sentence, two target phrases of seeded random tokens (ids 4..9999)
SEARCH_PHRASE_SEED = 21
# the fp32 card-vs-CPU decodes: 32 steps (cut from 64 for the script's time
# limit; the bf16 runs keep 64), K3 held in place at three of them
SEARCH_PARITY_STEPS = 32
SEARCH_PARITY_K3_STEPS = (5, 15, 31)


def search_phrases():
    rng = np.random.default_rng(SEARCH_PHRASE_SEED)
    return [[[int(t) for t in rng.integers(4, 10000, size=2)], [int(rng.integers(4, 10000))]]
            for _ in range(SEARCH_BATCH)]


@contextlib.contextmanager
def k3_held_in_place(torch, dec_attn, steps=(5, 31, 63)):
    """While open, every K3 launch at a decode step in ``steps`` is held
    against the plain version on clones of its own inputs (fp32, tolerance
    1e-4; the cache rows it writes bit-equal to the plain version's), at
    the ancestry the search really built. Yields a record: launches checked,
    the largest error, and the share of ancestry entries up to the step that
    are not the identity (0 for a never-permuted ancestry)."""
    k3 = dec_attn.decode_attention_cuda
    rec = {"checked": 0, "max_abs_err": 0.0, "non_identity": []}

    def checked(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam):
        if cache_index not in steps or q.dtype != torch.float32:
            return k3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam)
        kc, vc = k_cache.clone(), v_cache.clone()
        ref = dec_attn.decode_attention_plain(q, k_new, v_new, kc, vc, ancestry, cache_index,
                                              beam)
        out = k3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam)
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err(out, ref))
        if not (torch.equal(k_cache[:, :, cache_index], kc[:, :, cache_index])
                and torch.equal(v_cache[:, :, cache_index], vc[:, :, cache_index])):
            raise AssertionError(f"K3 step {cache_index}: cache rows differ from the plain "
                                 "version's")
        N = q.shape[0]
        own = (torch.arange(N, device=q.device) % beam).to(torch.int32)
        rec["non_identity"].append(float((ancestry[:cache_index + 1] != own).float().mean()))
        rec["checked"] += 1
        return out

    dec_attn.decode_attention_cuda = checked
    try:
        yield rec
    finally:
        dec_attn.decode_attention_cuda = k3


@contextlib.contextmanager
def k3_snapshot(torch, dec_attn, step=63):
    """While open, keeps a copy of the inputs of the first K3 launch at
    ``step`` (layer 0), for timing the kernel afterwards at that ancestry."""
    k3 = dec_attn.decode_attention_cuda
    snap = {}

    def noted(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam):
        if cache_index == step and not snap:
            snap["args"] = [t.clone() for t in (q, k_new, v_new, k_cache, v_cache, ancestry)]
            snap["beam"] = beam
        return k3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam)

    dec_attn.decode_attention_cuda = noted
    try:
        yield snap
    finally:
        dec_attn.decode_attention_cuda = k3


def k3_time_snapshot(torch, dec_attn, snap, label, step=63):
    """K3 on a snapshot's (bf16) inputs: held against the fp32 plain version
    (2e-2, as phase 3; the cache rows it writes bit-equal), then it and its
    plain version timed, with the bytes bound of the cache rows that
    ancestry references before the step."""
    q, k_new, v_new, kc, vc, anc = snap["args"]
    C = snap["beam"]
    N, H, L, D = kc.shape
    S = N // C
    with torch.inference_mode():  # the snapshot's tensors were made in inference mode
        kc32, vc32 = kc.float(), vc.float()
        ref = dec_attn.decode_attention_plain(q.float(), k_new.float(), v_new.float(), kc32,
                                              vc32, anc, step, C)
        kc_k, vc_k = kc.clone(), vc.clone()
        err = max_err(dec_attn.decode_attention_cuda(q, k_new, v_new, kc_k, vc_k, anc, step, C),
                      ref)
        check(f"K3 bf16 at {label}'s step-{step} ancestry vs fp32 plain", err, 2e-2)
        for got, want in ((kc_k, kc32), (vc_k, vc32)):
            if not torch.equal(got.float(), want):
                raise AssertionError(f"K3 bf16 at {label}'s ancestry: the cache after the call "
                                     "differs from the plain one")
        ms = cuda_ms(lambda: dec_attn.decode_attention_cuda(q, k_new, v_new, kc, vc, anc, step,
                                                            C), reps=50)
        plain_ms = cuda_ms(lambda: dec_attn.decode_attention_plain(q, k_new, v_new, kc, vc, anc,
                                                                   step, C), reps=50)
    anc_np = anc.cpu().numpy()
    # the step's own row is read from k_new / v_new, counted in the 6 N H D
    rows = sum(len(set(anc_np[l, s * C:(s + 1) * C])) for s in range(S) for l in range(step))
    e = q.element_size()
    n_bytes = 2 * rows * H * D * e + 6 * N * H * D * e + (step + 1) * N * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * N * H * (step + 1) * D)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "distinct_rows": rows, "max_abs_err": err}


SEARCH_MODES = ("beam", "diverse_groups", "diverse_siblings", "ordered_constraints",
                "unordered_constraints", "ensemble", "lm_fusion", "score_reference",
                "print_alignment", "kv_cache_int8", "sampling_topk1", "retain_dropout")
SEARCH_LM_WEIGHT = 0.3


def run_search_mode(torch, name, models, enc, wav, mask, seed=1, lm=None, max_decode_len=64):
    """One generation mode of the flagship on (wav, mask) -> its results.
    ``models`` holds two seeded models (the second for the ensemble), on one
    device; ``enc`` [(encoder_out, mask)] per model is reused by the modes
    that decode from the encoder, or None (they encode here); ``lm`` is the
    language model of ``lm_fusion`` on the same device."""
    from chimera_st_tpu_torch.generation import search_strategies as ss
    from chimera_st_tpu_torch.generation.ensemble import EnsembleSequenceGenerator
    from chimera_st_tpu_torch.generation.generator import (
        GeneratorSettings,
        SequenceGenerator,
        seeded_generator,
    )
    from chimera_st_tpu_torch.generation.scorer import SequenceScorer

    m0 = models[0]

    def settings(**kw):
        return GeneratorSettings(beam_size=10, max_decode_len=max_decode_len, len_penalty=1.5,
                                 min_len=30, **kw)

    def decode(gen, **kw):
        t = gen.generate_audio(wav, mask) if enc is None else gen.generate_from_encoder(*enc[0],
                                                                                       **kw)
        return {"tokens": t[0], "scores": t[1], "lens": t[2]}

    if name == "beam":
        return decode(SequenceGenerator(m0, settings()))
    if name == "diverse_groups":
        return decode(SequenceGenerator(m0, settings(diverse_beam_groups=2,
                                                     diverse_beam_strength=0.5)))
    if name == "diverse_siblings":
        return decode(SequenceGenerator(m0, settings(diversity_rate=0.5)))
    if name in ("ordered_constraints", "unordered_constraints"):
        phrases = search_phrases()
        strategy = (ss.LexicallyConstrainedSearch(ss.pack_constraints(phrases))
                    if name.startswith("ordered") else
                    ss.UnorderedLexicallyConstrainedSearch(ss.pack_constraint_phrases(phrases)))
        return decode(SequenceGenerator(m0, settings(), strategy=strategy))
    if name in ("ensemble", "lm_fusion"):
        members, fused = (models, None) if name == "ensemble" else \
            (models[:1], (lm, SEARCH_LM_WEIGHT))
        ens = EnsembleSequenceGenerator(members, settings(), lm=fused)
        t = ens.generate_audio(wav, mask) if enc is None else \
            ens.generate_from_encoders(enc[:len(members)])
        return {"tokens": t[0], "scores": t[1], "lens": t[2]}
    if name == "score_reference":
        rng = np.random.default_rng(5)
        target = np.full((wav.shape[0], 21), 1, np.int64)
        for b in range(wav.shape[0]):
            n = int(rng.integers(6, 21))
            target[b, :n] = rng.integers(4, 10000, size=n)
            target[b, n] = 2
        res = SequenceScorer(m0).score_audio(wav, mask, torch.from_numpy(target).to(wav.device))
        return {"score": res["score"], "positional": res["positional_scores"]}
    if name == "print_alignment":
        res = decode(SequenceGenerator(m0, settings()))
        with torch.inference_mode():
            e, em = enc[0] if enc is not None else m0.encode_audio(wav, mask)
            toks = res["tokens"][:, 0]
            prev = torch.cat([torch.full_like(toks[:, :1], 2), toks[:, :-1]], dim=1)
            res["attn"] = m0.decoder.cross_attention_weights(prev, e, em)
        return res
    if name == "kv_cache_int8":
        return decode(SequenceGenerator(m0, settings(kv_cache_int8=True)))
    if name == "sampling_topk1":
        # the draws of a served generator's first call
        return decode(SequenceGenerator(m0, settings(sampling=True, sampling_topk=1, seed=seed)),
                      sample_generator=seeded_generator(seed, 1, wav.device))
    if name == "retain_dropout":
        t = SequenceGenerator(m0, settings(retain_dropout=True, seed=seed)).generate_audio(
            wav, mask)
        return {"tokens": t[0], "scores": t[1], "lens": t[2]}
    raise KeyError(name)


def greedy_positions(torch, model, enc, res):
    """Top-k 1 sampling is greedy decoding: (positions that decide, whether
    the best sample's token there is the argmax of the model's teacher-
    forced log-probs). Decided: inside the sample, eos not banned (below
    min_len 30) or forced (the last step), top two apart by more than 1e-4."""
    toks, lens = res["tokens"][:, 0], res["lens"][:, 0]
    with torch.inference_mode():
        prev = torch.cat([torch.full_like(toks[:, :1], 2), toks[:, :-1]], dim=1)
        lp = torch.log_softmax(model.decode(prev, *enc).float(), -1)
        lp[:, :, 1] = -1e9  # pad is never drawn
        lp[:, :30, 2] = -1e9  # eos banned while the length is at most min_len
        top2 = lp.topk(2, dim=-1)
        pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
        clear = ((top2.values[..., 0] - top2.values[..., 1]) > 1e-4) & (pos < lens[:, None] - 1)
        return torch.stack([clear, top2.indices[..., 0] == toks])


def search_launches(name, layer_steps):
    """The exact launches of one mode's batch (encode included) for the
    decoder layer steps that ran (counted over every model's decoder, and
    the language model's)."""
    k1, k2 = 24, 6  # 12 trunk + 12 shared-encoder layers; 6 conv-tail layers
    k3 = layer_steps  # one a layer a step: 6 decoder layers (+ 12 of the LM)
    if name == "ensemble":
        k1, k2 = 2 * k1, 2 * k2
    elif name == "score_reference":
        k3 = 0  # teacher forcing: no cached step
    elif name == "print_alignment":
        k1, k2 = 2 * k1, 2 * k2  # the alignment pass encodes once more
    elif name == "kv_cache_int8":
        k3 = 0  # the int8 cache runs its plain PyTorch path
    elif name == "retain_dropout":
        k1 = 0  # attention dropout 0.1 takes the plain path
    return {"encoder_attention": k1, "conv_tail": k2, "decode_attention": k3, "logmel": 0}


def phase_search(torch, build0, build1, build_lm, kernels, dec_attn):
    """The flagship's generation surface on one seeded batch of SEARCH_BATCH
    utterances of 2-6 s, beam 10: each mode in fp32 on the card (kernels;
    K3 held in place at the mode's ancestries) and on the CPU (plain
    versions) from the same weights, SEARCH_PARITY_STEPS decoder steps, best
    hypotheses token-identical and scores within the parity phase's 1e-4;
    then each mode in bf16 on the card between CUDA events, max_decode_len
    64, counts zeroed before and exact after.
    Returns ({mode: launches}, {mode: K3 record})."""
    wav_np, mask_np = make_audio(np.random.default_rng(17), SEARCH_BATCH, 2.0, 6.0)
    log(f"search: flagship, {SEARCH_BATCH} utterances of "
        f"{(~mask_np).sum(1).min() / 16000:.2f}..{(~mask_np).sum(1).max() / 16000:.2f} s, "
        f"beam 10, max_decode_len 64; fp32 card (kernels) vs CPU (plain), then bf16 timing")
    results, k3_recs = {}, {}
    for on_card, device in ((True, "cuda"), (False, "cpu")):
        models = [build0(device, torch.float32), build1(device, torch.float32)]
        lm = build_lm(device, torch.float32)
        wav = torch.tensor(wav_np, device=device)
        mask = torch.tensor(mask_np, device=device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            enc = [m.encode_audio(wav, mask) for m in models]
        log(f"  {device}: both models encoded in {time.perf_counter() - t0:.2f} s")
        for name in SEARCH_MODES:
            if name == "retain_dropout":
                continue  # its masks come from each device's own generator
            t0 = time.perf_counter()
            if on_card:
                with k3_held_in_place(torch, dec_attn, SEARCH_PARITY_K3_STEPS) as rec:
                    res = run_search_mode(torch, name, models, enc, wav, mask, lm=lm,
                                          max_decode_len=SEARCH_PARITY_STEPS)
                k3_recs[name] = rec
            else:
                res = run_search_mode(torch, name, models, enc, wav, mask, lm=lm,
                                      max_decode_len=SEARCH_PARITY_STEPS)
                if name == "sampling_topk1":
                    res["greedy"] = greedy_positions(torch, models[0], enc[0], res)
            results.setdefault(name, {})["card" if on_card else "host"] = {
                k: v.cpu() for k, v in res.items()}
            log(f"  {device} {name}: {time.perf_counter() - t0:.2f} s")
        del models, enc, lm
    for name, r in results.items():
        g, c = r["card"], r["host"]
        if name == "score_reference":
            check("search score_reference: mean log-prob, card vs CPU",
                  max_err(g["score"], c["score"]), 1e-4)
            check("search score_reference: every token's log-prob, card vs CPU",
                  max_err(g["positional"], c["positional"]), 1e-3)
            continue
        for b in range(SEARCH_BATCH):
            if not torch.equal(g["tokens"][b, 0], c["tokens"][b, 0]) \
                    or int(g["lens"][b, 0]) != int(c["lens"][b, 0]):
                raise AssertionError(f"search {name}: best hypothesis of sentence {b} differs "
                                     f"between the card and the CPU")
        same_beams = int((g["tokens"] == c["tokens"]).all(dim=2).sum())
        check(f"search {name}: {SEARCH_BATCH} best hypotheses token-identical "
              f"({same_beams} of {g['tokens'].shape[0] * g['tokens'].shape[1]} beams); best "
              "scores", max_err(g["scores"][:, 0], c["scores"][:, 0]), 1e-4)
        if name == "print_alignment":
            check("search print_alignment: cross-attention weights, card vs CPU",
                  max_err(g["attn"], c["attn"]), 1e-4)
            top2 = c["attn"].topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 1e-4
            if not torch.equal(g["attn"].argmax(-1)[clear], c["attn"].argmax(-1)[clear]):
                raise AssertionError("search print_alignment: alignments differ")
        if name in ("ordered_constraints", "unordered_constraints"):
            for b, phrases in enumerate(search_phrases()):
                hyp = g["tokens"][b, 0, :int(g["lens"][b, 0])].tolist()
                for p in phrases:
                    if not any(hyp[j:j + len(p)] == p for j in range(len(hyp))):
                        raise AssertionError(f"search {name}: sentence {b} lacks phrase {p}")
        if name == "sampling_topk1":
            clear, agree = c["greedy"][0], c["greedy"][1]
            if not bool(agree[clear].all()):
                raise AssertionError("search sampling_topk1: not the greedy decode")
            log(f"  search sampling_topk1: the greedy token at {int(clear.sum())} of "
                f"{clear.numel()} positions (the rest within 1e-4 of a tie, forced, or past "
                "the end)")
        rec = k3_recs.get(name, {"checked": 0})
        if rec["checked"]:
            check(f"search {name}: K3 in place at steps {SEARCH_PARITY_K3_STEPS}, "
                  f"{rec['checked']} launches "
                  f"at ancestries {100 * max(rec['non_identity']):.1f} % off the identity",
                  rec["max_abs_err"], 1e-4)
            if name == "sampling_topk1" and max(rec["non_identity"]) != 0.0:
                raise AssertionError("search sampling: the ancestry was permuted")
    # bf16 timing, counts exact
    models = [build0("cuda", torch.bfloat16), build1("cuda", torch.bfloat16)]
    lm = build_lm("cuda", torch.bfloat16)
    wav, mask = torch.tensor(wav_np, device="cuda"), torch.tensor(mask_np, device="cuda")
    run_search_mode(torch, "beam", models, None, wav, mask)  # warm-up
    torch.cuda.synchronize()
    counts, times, snaps, first = {}, {n: [] for n in SEARCH_MODES}, {}, {}
    for rep in range(SEARCH_REPS):  # the modes in turn; later rounds retained dropout alone
        for name in SEARCH_MODES if rep == 0 else ("retain_dropout",):
            for fn in kernels:
                fn.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with counted_decoder_steps() as steps, k3_snapshot(torch, dec_attn) as snap:
                start.record()
                res = run_search_mode(torch, name, models, None, wav, mask, seed=3, lm=lm)
                end.record()
                end.synchronize()
            times[name].append(start.elapsed_time(end))
            counts[name] = {fn.__name__: fn.launches for fn in kernels}
            implied = search_launches(name, steps[1])
            if counts[name] != implied:
                raise AssertionError(f"search {name} launches {counts[name]}, the batch "
                                     f"implies {implied}")
            for key, t in res.items():
                if not torch.isfinite(t.float()).all():
                    raise AssertionError(f"search {name}: {key} not finite")
            res = {k: v.cpu() for k, v in res.items()}
            if rep == 0:
                first[name] = res
                if snap:
                    snaps[name] = snap
            elif name == "retain_dropout" and not torch.equal(res["tokens"],
                                                              first[name]["tokens"]):
                raise AssertionError("search retain_dropout: the same seed gave other tokens")
    rates = {}
    for name, ms in times.items():
        med = statistics.median(ms)
        rates[name] = {"ms": med, "ms_min": min(ms), "ms_max": max(ms),
                       "sentences_per_s": SEARCH_BATCH / med * 1e3,
                       "vs_beam": statistics.median(times["beam"]) / med,
                       "launches": counts[name]}
        log(f"  bf16 {name}: median {med:.1f} ms ({min(ms):.1f}-{max(ms):.1f}) over "
            f"{len(ms)} run(s), {SEARCH_BATCH / med * 1e3:.2f} sentences/s, "
            f"{rates[name]['vs_beam']:.2f}x plain beam; launches {counts[name]} (each run)")
    if torch.equal(first["beam"]["tokens"], first["retain_dropout"]["tokens"]):
        raise AssertionError("search retain_dropout: the dropout changed nothing")
    log(f"  retain_dropout: the same seed gave the same tokens in all {SEARCH_REPS} runs on "
        "the card; they differ from plain beam search's")
    k3_times = {}
    for name, snap in snaps.items():
        k3_times[name] = k3_time_snapshot(torch, dec_attn, snap, name)
        t = k3_times[name]
        log(f"  K3 bf16 at {name}'s step-63 ancestry: {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
            f"{t['distinct_rows']} distinct rows; {100 * t['bound_share']:.1f} %)")
    del models, lm
    print(json.dumps({"search": {"modes": rates, "k3_at_ancestry": k3_times,
                                 "k3_in_place": {n: {"checked": r["checked"],
                                                     "max_abs_err": r["max_abs_err"],
                                                     "non_identity": max(r["non_identity"],
                                                                         default=0.0)}
                                                 for n, r in k3_recs.items()}}}), flush=True)
    return counts, k3_times


# ---- fbank features: the s2t_transformer_s preset served by the generate CLI
# on precomputed features (.npy and zip-packed) with utterance CMVN

FBANK_UTTS = 16
FBANK_ARCH = {"arch": "s2t_transformer_s"}


def make_fbank_fixture(torch, root: Path, seed: int = 23) -> dict:
    """16 seeded utterances of 200-600 frames of 80-d features (8 as .npy,
    8 zip-packed: stored members addressed by byte offset and length), an
    8,000-entry dictionary, a config naming utterance_cmvn for '*' and
    specaugment + utterance_cmvn for _train (parameters at the top level),
    and a native .ckpt of a seeded s2t_transformer_s."""
    import zipfile

    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.models.s2t_transformer import build_s2t_transformer

    rng = np.random.default_rng(seed)
    (root / "feats").mkdir(parents=True)
    feats = [(rng.normal(size=(int(n), 80)) * 4.0 + rng.normal(size=80) * 6.0).astype(np.float32)
             for n in rng.integers(200, 601, size=FBANK_UTTS)]
    half = FBANK_UTTS // 2
    with zipfile.ZipFile(root / "feats.zip", "w", zipfile.ZIP_STORED) as z:
        for i in range(half, FBANK_UTTS):
            with z.open(f"u{i}.npy", "w") as f:
                np.save(f, feats[i])
    audio = {}
    with zipfile.ZipFile(root / "feats.zip") as z:
        for info in z.infolist():
            offset = info.header_offset + 30 + len(info.filename.encode()) + len(info.extra)
            audio[int(info.filename[1:-4])] = f"feats.zip:{offset}:{info.file_size}"
    for i in range(half):
        np.save(root / "feats" / f"u{i}.npy", feats[i])
        audio[i] = f"feats/u{i}.npy"
    words = [f"w{i}" for i in range(8000 - 4)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    rows = "".join(f"u{i}\t{audio[i]}\t{len(f)}\t"
                   f"{' '.join(rng.choice(words, size=int(rng.integers(5, 20))))}\tspk\n"
                   for i, f in enumerate(feats))
    (root / "tst_fbank.tsv").write_text("id\taudio\tn_frames\ttgt_text\tspeaker\n" + rows)
    (root / "config_wave.yaml").write_text(json.dumps({
        "audio_root": str(root), "use_audio_input": False, "input_feat_per_channel": 80,
        "vocab_filename": "dict.txt",
        "transforms": {"*": ["utterance_cmvn"], "_train": ["specaugment", "utterance_cmvn"]},
        "specaugment": {"freq_mask_N": 2, "freq_mask_F": 27, "time_mask_N": 2,
                        "time_mask_T": 100, "time_mask_p": 1.0},
        "utterance_cmvn": {"norm_means": True, "norm_vars": True}}))
    model_cfg = dict(FBANK_ARCH)
    arch = model_cfg.pop("arch")
    model = init_params_(build_s2t_transformer(arch, {**model_cfg, "tgt_vocab_size": 8000},
                                               device="cpu"),
                         torch.Generator().manual_seed(seed))
    ckpt = root / "s2t_s.ckpt"
    save_model(str(ckpt), model, FBANK_ARCH, "s2t")
    log(f"fbank fixture: {FBANK_UTTS} utterances, {sum(len(f) for f in feats)} frames "
        f"({half} .npy, {FBANK_UTTS - half} zip-packed), dictionary of 8000, {ckpt.name} "
        f"{ckpt.stat().st_size / 1e6:.0f} MB")
    return {"root": root, "ckpt": ckpt, "feats": feats}


def phase_fbank_features(torch, root: Path, kernels):
    """cli.generate --task speech_to_text on the fixture's features, beam 5:
    fp32 on the card and with --device cpu, best hypotheses identical as
    strings; then bf16 on the card with the counts zeroed before and exact
    after (K1 12 a batch, K3 6 a decoder step, K2 and K4 0)."""
    from chimera_st_tpu_torch.cli import generate
    from chimera_st_tpu_torch.data.manifests import S2TDataConfig, make_dataset_from_tsv
    from chimera_st_tpu_torch.data.dictionary import Dictionary

    fx = make_fbank_fixture(torch, root)
    # the transforms the data layer applies: utterance CMVN on this split
    data_cfg = S2TDataConfig(str(root / "config_wave.yaml"))
    ds = make_dataset_from_tsv(str(root), "tst_fbank", data_cfg,
                               Dictionary.load(str(root / "dict.txt")), False)
    x = fx["feats"][FBANK_UTTS - 1]
    check("fbank_features: a zip-packed utterance after utterance_cmvn vs numpy",
          float(np.abs(ds[FBANK_UTTS - 1].audio - (x - x.mean(0)) / x.std(0)).max()), 1e-5)

    def run(out, extra):
        (root / out).mkdir()
        t0 = time.perf_counter()
        stats = generate.main([str(root), "--task", "speech_to_text", "--path", str(fx["ckpt"]),
                               "--gen-subset", "tst_fbank", "--beam", "5", "--max-decode-len",
                               "64", "--batch-size", "8", "--scoring", "bleu",
                               "--results-path", str(root / out), *extra])
        return ((root / out / "generate-tst_fbank.txt").read_text(), stats,
                time.perf_counter() - t0)

    log(f"fbank_features: cli.generate --task speech_to_text, s2t_transformer_s, beam 5, "
        f"{FBANK_UTTS} utterances in batches of 8, fp32 card vs --device cpu")
    gpu_text, _, gpu_s = run("fp32_cuda", ["--dtype", "float32"])
    cpu_text, _, cpu_s = run("fp32_cpu", ["--dtype", "float32", "--device", "cpu"])
    (gh, gfull, glast), (ch, cfull, clast) = parse_protocol(gpu_text), parse_protocol(cpu_text)
    if len(gfull) != FBANK_UTTS or len(cfull) != FBANK_UTTS:
        raise AssertionError(f"fbank_features: samples with all lines {len(gfull)}, "
                             f"{len(cfull)}")
    same_hypotheses("fbank_features", gh, ch, FBANK_UTTS)
    if glast != clast:
        raise AssertionError(f"fbank_features: corpus lines differ:\n  {glast}\n  {clast}")
    log(f"  card {gpu_s:.1f} s, CPU {cpu_s:.1f} s; {glast}")
    for fn in kernels:
        fn.launches = 0
    with counted_decoder_steps() as steps:
        text, stats, wall = run("bf16", ["--dtype", "bfloat16"])
        torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in kernels}
    batches = -(-FBANK_UTTS // 8)
    implied = {"encoder_attention": 12 * batches, "conv_tail": 0,
               "decode_attention": 6 * steps[0], "logmel": 0}
    if counts != implied or steps[0] == 0:
        raise AssertionError(f"fbank_features launches {counts}, the batches imply {implied}")
    hyps, full, _ = parse_protocol(text)
    if len(full) != FBANK_UTTS or not all(np.isfinite(h[0][0]) for h in hyps.values()):
        raise AssertionError("fbank_features: bf16 output incomplete or not finite")
    rec = {"sentences": stats["sentences"], "wall_s": wall,
           "sentences_per_s": stats["sentences"] / stats["decode_s"], "load_s": stats["load_s"],
           "decoder_steps": steps[0], "launches": counts}
    log(f"  bf16: {stats['sentences'] / stats['decode_s']:.2f} sentences/s, launches {counts}")
    print(json.dumps({"fbank_features": rec}), flush=True)
    return counts


# ---- the fairseq Transformer family: transformer_wmt_en_de_big and
# transformer_iwslt_de_en served by cli.generate --task translation, a
# transformer_lm of GPT widths fused in with --lm-path, and eval_lm

FAMILY_VOCAB = 32768  # one joined dictionary: the size fairseq's WMT'16 en-de big dictionary is near
FAMILY_TEST_PAIRS = 32  # cut from 64 for the script's time limit: one batch of 32
FAMILY_PARITY_PAIRS = 1  # cut from 4, then 2, for the script's time limit
FAMILY_BATCH = 32
FAMILY_DECODE = ["--beam", "4", "--lenpen", "0.6", "--max-decode-len", "64"]  # WMT'16 en-de big
LM_STREAM_TOKENS = 100_000  # cut from 200,000 for the script's time limit
LM_BLOCK = 512
# transformer_lm_gpt's widths, stated; 4 of its 12 layers (cut for the
# script's time limit)
LM_GPT = {"arch": "transformer_lm", "embed_dim": 768, "ffn_dim": 3072, "layers": 4,
          "heads": 12, "activation": "gelu"}
FAMILY_MODELS = {"mt_big": {"arch": "transformer_wmt_en_de_big"},
                 "iwslt": {"arch": "transformer_iwslt_de_en"}}


def zipf_rows(rng, words, p, n_rows, lengths=MT_LENGTHS):
    """n_rows sentences of Zipf-drawn words, lengths uniform in ``lengths``;
    -> (the text lines, the word ids drawn)."""
    lens = rng.integers(lengths[0], lengths[1] + 1, n_rows)
    ids = rng.choice(len(words), size=int(lens.sum()), p=p)
    rows = np.split(words[ids], np.cumsum(lens)[:-1])
    return [" ".join(r) for r in rows], ids


def make_family_fixture(root: Path, seed: int = 29) -> dict:
    """Seeded text over one joined dictionary of FAMILY_VOCAB subwords
    (Zipf exponent 1.1), binarized by the port's preprocess CLI: MT en -> de
    with FAMILY_TEST_PAIRS test pairs of 4-120 subwords (targets within
    +-20 % of the source's length) and FAMILY_PARITY_PAIRS more as the
    ``valid`` split; a monolingual stream of LM_STREAM_TOKENS tokens in
    sentences of 4-120 (``--only-source``: split ``test``, and its leading
    sentences up to 8 blocks of LM_BLOCK tokens as split ``valid``)."""
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(seed)
    n_words = FAMILY_VOCAB - 4
    words = np.asarray([f"s{i}" for i in range(n_words)])
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    raw = root / "raw"
    raw.mkdir(parents=True)
    counts = np.zeros(n_words, np.int64)
    for split, n in (("test", FAMILY_TEST_PAIRS), ("valid", FAMILY_PARITY_PAIRS)):
        src, ids = zipf_rows(rng, words, p, n)
        counts += np.bincount(ids, minlength=n_words)
        tgt = []
        for line in src:
            n_tgt = max(1, int(round(len(line.split()) * rng.uniform(0.8, 1.2))))
            t_ids = rng.choice(n_words, size=n_tgt, p=p)
            counts += np.bincount(t_ids, minlength=n_words)
            tgt.append(" ".join(words[t_ids]))
        (raw / f"{split}.en").write_text("\n".join(src) + "\n")
        (raw / f"{split}.de").write_text("\n".join(tgt) + "\n")
    stream, n_stream = [], 0
    while n_stream < LM_STREAM_TOKENS:
        rows, ids = zipf_rows(rng, words, p, 256)
        counts += np.bincount(ids, minlength=n_words)
        stream += rows
        n_stream += len(ids)
    head, n_head = [], 0
    for row in stream:  # + eos per sentence, as binarized
        if n_head >= 8 * LM_BLOCK:
            break
        head.append(row)
        n_head += len(row.split()) + 1
    (raw / "lm.txt").write_text("\n".join(stream) + "\n")
    (raw / "lm_head.txt").write_text("\n".join(head) + "\n")
    dict_file = root / "dict.txt"
    dict_file.write_text("".join(f"{w} {c}\n" for w, c in zip(words, np.maximum(counts, 1))))
    t0 = time.perf_counter()
    preprocess.main(["-s", "en", "-t", "de", "--joined-dictionary", "--srcdict", str(dict_file),
                     "--validpref", str(raw / "valid"), "--testpref", str(raw / "test"),
                     "--destdir", str(root / "mt")])
    preprocess.main(["--only-source", "--srcdict", str(dict_file), "--testpref",
                     str(raw / "lm.txt"), "--validpref", str(raw / "lm_head.txt"),
                     "--destdir", str(root / "lm")])
    stream_tokens = sum(len(r.split()) + 1 for r in stream)
    log(f"family fixture: {FAMILY_TEST_PAIRS} + {FAMILY_PARITY_PAIRS} MT pairs, an LM stream of "
        f"{stream_tokens} tokens ({len(stream)} sentences; {n_head} in its first "
        f"{len(head)}), a joined dictionary of {FAMILY_VOCAB}; binarized in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(root=root, mt=root / "mt", lm=root / "lm", stream_tokens=stream_tokens)


def family_checkpoint(torch, fx, name: str, model_cfg: dict, seed: int) -> Path:
    """A native checkpoint (the JAX layout, through the port's writer) of
    ``model_cfg`` built on the fixture's dictionary with seeded random
    weights (``init_params_``); ``model_cfg`` is what it stores."""
    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "language_modeling", "data": str(fx["lm"])}
                      if model_cfg["arch"].startswith("transformer_lm") else
                      {"_name": "translation", "data": str(fx["mt"]), "source_lang": "en",
                       "target_lang": "de"})
    t0 = time.perf_counter()
    model = init_params_(task.build_model(dict(model_cfg), device="cpu", train=True),
                         torch.Generator().manual_seed(seed))
    path = fx["root"] / f"{name}.ckpt"
    save_model(str(path), model, model_cfg)
    n = sum(p.numel() for p in model.parameters())
    log(f"  {name}: {model_cfg['arch']}, {n / 1e6:.1f} M parameters, {type(model).__name__}; "
        f"{path.stat().st_size / 1e9:.2f} GB written in {time.perf_counter() - t0:.1f} s")
    return path


def family_generate(fx, ckpt: Path, out_dir: Path, subset: str, extra):
    """cli.generate --task translation on the fixture -> (output text, its
    returned counts and times)."""
    from chimera_st_tpu_torch.cli import generate

    out_dir.mkdir(parents=True, exist_ok=True)
    stats = generate.main([str(fx["mt"]), "--task", "translation", "-s", "en", "-t", "de",
                           "--path", str(ckpt), "--gen-subset", subset, *FAMILY_DECODE,
                           "--scoring", "bleu", "--results-path", str(out_dir), *extra])
    return (out_dir / f"generate-{subset}.txt").read_text(), stats


def phase_family_serve(torch, fx, label: str, ckpt: Path, kernels, per_step: int, extra=(),
                       profile=True):
    """One model of the family through the generate CLI: fp32 on the card
    against --device cpu on the ``valid`` split (one batch of
    FAMILY_PARITY_PAIRS), best hypotheses identical; then bf16 on the
    ``test`` split in batches of FAMILY_BATCH with the launch counts zeroed
    before and read after: K1 (the encoder's layers) a batch, K3
    ``per_step`` a decoder step (the MT decoder's layers, and an LM's),
    K2 and K4 none. Returns the launches; prints {label: {...}}."""
    work = fx["root"] / label
    log(f"{label}: cli.generate --task translation {' '.join(FAMILY_DECODE + list(extra))}; "
        f"fp32 card vs CPU on {FAMILY_PARITY_PAIRS} pairs, then bf16 on "
        f"{FAMILY_TEST_PAIRS} in batches of {FAMILY_BATCH}")
    common = ["--batch-size", str(FAMILY_PARITY_PAIRS), "--dtype", "float32", *extra,
              *PARITY_DECODE]
    t0 = time.perf_counter()
    gpu_text, _ = family_generate(fx, ckpt, work / "parity_cuda", "valid", common)
    gpu_s = time.perf_counter() - t0
    cpu_text, _ = family_generate(fx, ckpt, work / "parity_cpu", "valid",
                                  common + ["--device", "cpu"])
    log(f"  fp32: card {gpu_s:.1f} s, CPU {time.perf_counter() - t0 - gpu_s:.1f} s")
    (gh, gfull, _), (ch, cfull, _) = parse_protocol(gpu_text), parse_protocol(cpu_text)
    if len(gfull) != FAMILY_PARITY_PAIRS or len(cfull) != FAMILY_PARITY_PAIRS:
        raise AssertionError(f"{label}: samples with all lines, card {len(gfull)}, CPU "
                             f"{len(cfull)}")
    same_hypotheses(f"{label} fp32 card vs CPU", gh, ch, FAMILY_PARITY_PAIRS)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_decoder_steps() as steps:
        t0 = time.perf_counter()
        text, stats = family_generate(fx, ckpt, work / "serve", "test",
                                      ["--batch-size", str(FAMILY_BATCH), "--dtype", "bfloat16",
                                       *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    hyps, full, last = parse_protocol(text)
    batches = -(-FAMILY_TEST_PAIRS // FAMILY_BATCH)
    decoders = 2 if "--lm-path" in extra else 1  # the MT decoder, and the LM's
    mt_steps = steps[0] // decoders
    layers = 6  # the encoder's layers in both presets
    implied = {"encoder_attention": layers * batches, "conv_tail": 0,
               "decode_attention": per_step * mt_steps, "logmel": 0}
    rec = {"sentences": stats["sentences"], "wall_s": wall, "decode_s": stats["decode_s"],
           "load_s": stats["load_s"], "sentences_per_s": stats["sentences"] / stats["decode_s"],
           "decoder_steps": mt_steps, "peak_memory_gb": peak / 1e9, "launches": counts}
    log(f"  bf16: {stats['sentences']} sentences in {wall:.1f} s (decode "
        f"{stats['decode_s']:.2f} s, {rec['sentences_per_s']:.1f} sentences/s; load "
        f"{stats['load_s']:.2f} s), {mt_steps} decoder steps for {batches} batches; peak "
        f"{peak / 1e9:.2f} GB; launches {counts}; {last}")
    if (counts != implied or steps[1] != per_step * mt_steps or mt_steps == 0
            or steps[0] != decoders * mt_steps
            or len(full) != FAMILY_TEST_PAIRS
            or any(not np.isfinite(h[0][0]) for h in hyps.values())):
        raise AssertionError(f"{label}: launches {counts} (want {implied}), {len(full)} samples")
    if not profile:  # cut for the script's time limit
        print(json.dumps({label: rec}), flush=True)
        return counts
    # the device's busy share: one more batch (the valid split) under --profile
    family_generate(fx, ckpt, work / "profiled", "valid",
                    ["--batch-size", str(FAMILY_PARITY_PAIRS), "--dtype", "bfloat16",
                     "--profile", str(work / "trace"), *extra])
    rec["profile_one_batch"] = trace_busy(work / "trace" / "trace.json")
    log(f"  one batch of {FAMILY_PARITY_PAIRS} under --profile: device busy "
        f"{100 * rec['profile_one_batch']['busy_share']:.1f} % of "
        f"{rec['profile_one_batch']['wall_ms']:.0f} ms")
    print(json.dumps({label: rec}), flush=True)
    return counts


def phase_eval_lm(torch, fx, ckpt: Path, kernels):
    """cli.eval_lm on the seeded stream, --tokens-per-sample LM_BLOCK, context
    windows 0 and LM_BLOCK / 2: fp32 card vs CPU on the stream's first 8
    blocks (split ``valid``, loss within 1e-5 bits/token), then the whole
    stream in bf16 on the card with the counts zeroed: no kernel launches
    (the forward is causal). Returns the launches; prints {"eval_lm": ...}."""
    from chimera_st_tpu_torch.cli import eval_lm

    rec = {}
    for ctx in (0, LM_BLOCK // 2):
        argv = [str(fx["lm"]), "--path", str(ckpt), "--tokens-per-sample", str(LM_BLOCK),
                "--context-window", str(ctx), "--batch-size", "8"]
        t0 = time.perf_counter()
        gpu = eval_lm.main(argv + ["--gen-subset", "valid", "--dtype", "float32"])
        cpu = eval_lm.main(argv + ["--gen-subset", "valid", "--dtype", "float32",
                                   "--device", "cpu"])
        check(f"eval_lm context {ctx}: fp32 card vs CPU over {gpu['tokens']} tokens, "
              "bits/token", abs(gpu["loss_bits"] - cpu["loss_bits"]), 1e-5)
        log(f"  fp32 pair {time.perf_counter() - t0:.1f} s")
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = eval_lm.main(argv + ["--gen-subset", "test", "--dtype", "bfloat16"])
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in kernels}
        if any(counts.values()) or out["tokens"] != fx["stream_tokens"] \
                or not np.isfinite(out["loss_bits"]):
            raise AssertionError(f"eval_lm context {ctx}: launches {counts}, {out['tokens']} "
                                 f"tokens of {fx['stream_tokens']}")
        rec[f"context_{ctx}"] = dict(out, tokens_per_s=out["tokens"] / out["eval_s"],
                                     wall_s=time.perf_counter() - t0,
                                     peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                                     fp32_card_vs_cpu_bits=abs(gpu["loss_bits"]
                                                               - cpu["loss_bits"]))
        log(f"  context {ctx}: bf16 {out['tokens']} tokens in {out['eval_s']:.2f} s "
            f"({rec[f'context_{ctx}']['tokens_per_s']:.0f} tokens/s), loss "
            f"{out['loss_bits']:.4f} bits/token; launches {counts}")
    print(json.dumps({"eval_lm": rec}), flush=True)
    return counts


def phase_family(torch, work: Path, kernels, enc_attn, conv_tail, dec_attn):
    """mt_big, lm_fusion, eval_lm, iwslt, lm_fusion_wide and
    lm_fusion_adaptive on one fixture.
    Returns (the fixture, {phase: launches}, the K1 / K3 shapes seen)."""
    fx = make_family_fixture(work / "family")
    ckpts = {name: family_checkpoint(torch, fx, name, cfg, seed)
             for (name, cfg), seed in zip(FAMILY_MODELS.items(), (31, 37))}
    ckpts["lm"] = family_checkpoint(torch, fx, "lm", LM_GPT, 41)
    counts = {}
    t0 = time.perf_counter()

    def took(label):
        log(f"  ({label}: {time.perf_counter() - t0:.1f} s into the family phases)")

    with recorded_shapes(enc_attn, conv_tail, dec_attn) as seen:
        counts["mt_big"] = phase_family_serve(torch, fx, "mt_big", ckpts["mt_big"], kernels, 6)
        took("mt_big")
        # one --profile batch (mt_big's) for the family's busy share: the
        # fused and iwslt ones cut for the script's time limit
        counts["lm_fusion"] = phase_family_serve(
            torch, fx, "lm_fusion", ckpts["mt_big"], kernels, 6 + LM_GPT["layers"],
            ["--lm-path", str(ckpts["lm"]), "--lm-weight", "0.3"], profile=False)
        took("lm_fusion")
        counts["eval_lm"] = phase_eval_lm(torch, fx, ckpts["lm"], kernels)
        took("eval_lm")
        counts["iwslt"] = phase_family_serve(torch, fx, "iwslt", ckpts["iwslt"], kernels, 6,
                                             profile=False)
        took("iwslt")
        # the wider LMs fuse into iwslt (6 + 6 layers as mt_big, 65 M
        # parameters against 243.5 M: cut for the script's time limit)
        counts.update(phase_lm_fusion_wide(torch, fx, ckpts["iwslt"], kernels))
        took("lm_fusion_wide")
        counts.update(phase_lm_fusion_adaptive(torch, fx, ckpts["iwslt"], kernels))
        took("lm_fusion_adaptive")
    if not any(s[3] == 128 for s, _ in seen["encoder_attention"]) or \
            not all(any(s[3] == d for s, _ in seen["decode_attention"]) for d in (32, 96, 128)):
        raise AssertionError(f"the family phases launched no head-dim-128 K1, or no K3 at one of "
                             f"the head dims 32, 96, 128: {seen}")
    for path in ckpts.values():
        path.unlink()
    return fx, counts, seen


# ---- this slice: K3 at head dims 96 and 32, the plain w2v2 + Transformer
# ST model, training the Transformer family, a translation_tts update

K3_WIDE = (("d96_S32_C4_H32", 96, 32), ("d32_S32_C4_H16", 32, 16))


def k3_wide_cases(torch, dec_attn, tensor):
    """K3 at the head dims of the megatron LM presets (3072 / 32 heads: D 96)
    and of the gbw ones (512 / 16 heads: D 32): 32 sentences x beam 4, a
    64-step cache, steps 63, 31 and 0, as k3_step holds K3 (bf16 2e-2 and
    fp32 1e-4 against the fp32 plain version, caches bit-equal, NaN past
    the step)."""
    log("k3_wide: K3 decode_attention at head dims 96 and 32")
    out = {}
    for label, D, H in K3_WIDE:
        inputs = k3_inputs(torch, tensor, np.random.default_rng(D), 32, 4, H, 64, D=D)
        steps = {}
        for idx in (63, 31, 0):
            steps[idx] = k3_step(torch, dec_attn, inputs, label, 4, idx)
            steps[idx]["fp32"] = k3_fp32_time(torch, dec_attn, inputs, label, 4, idx)
        out[label] = dict(steps[63], steps={"0": steps[0], "31": steps[31]})
    return out


def k3_fp32_time(torch, dec_attn, inputs, label, C, idx):
    """The fp32 kernel's and plain version's times at one step of a K3
    case (the same values as k3_step's bf16 inputs, in fp32), beside the
    bound of its fp32 bytes and its operations at the fp32 peak."""
    q, k_new, v_new, kc, vc, anc, anc_np = inputs
    N, H, _, D = kc.shape
    b_ms, bound_by = bound_ms(k3_bytes(anc_np, N // C, C, H, D, idx, 4),
                              4 * N * H * (idx + 1) * D, FP32_FLOPS)
    q, k_new, v_new, kc, vc = (t.float() for t in (q, k_new, v_new, kc, vc))
    ms = cuda_ms(lambda: dec_attn.decode_attention_cuda(q, k_new, v_new, kc, vc, anc, idx, C),
                 reps=50)
    plain_ms = cuda_ms(lambda: dec_attn.decode_attention_plain(q, k_new, v_new, kc, vc, anc,
                                                               idx, C), reps=50)
    log(f"  {label} step {idx} fp32: kernel {ms:.4f} ms ({100 * b_ms / ms:.1f} % of its "
        f"{b_ms:.5f} ms bound), plain {plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=bound_by,
                bound_share=b_ms / ms)


# the plain w2v2 + Transformer ST model of the paper (no memory bank) at its
# small preset, the trunk as a released checkpoint builds it (12 heads)
W2V2_ST = {"arch": "s2t_transformer_w2v2_s", "w2v2_heads": 12}
W2V2_ST_ON_PATH = {"encoder_attention": 24, "conv_tail": 6, "decode_attention": 384}


def w2v2_st_builder(torch):
    """build(device, dtype) of ``s2t_transformer_w2v2_s`` through the
    registries (vocabularies of 10,000), seeded weights."""
    import chimera_st_tpu_torch.models  # noqa: F401 — registration
    from chimera_st_tpu_torch.config.registry import ARCHITECTURES, MODELS

    model_name, preset = ARCHITECTURES.get(W2V2_ST["arch"])
    cfg = preset({**W2V2_ST, "tgt_vocab_size": 10000, "src_vocab_size": 10000})
    return seeded_builder(torch, lambda d: MODELS.get(model_name)(cfg, device=d), seed=5)


def phase_w2v2_ckpt(torch, fx, work: Path, build, kernels):
    """The plain w2v2 model as a native ``.ckpt`` in the JAX trainer's layout
    (``model_cfg`` the preset's name and the trunk's 12 heads), decoded by
    the port's generate CLI in bf16 on the fixture's 24 wavs: every sample
    printed, launches exact (K1 24 and K2 6 a batch, K3 6 a decoder step).
    Returns the launches."""
    from chimera_st_tpu_torch.checkpoint.store import save_model

    path = work / "w2v2_st.ckpt"
    save_model(str(path), build("cpu", torch.float32), W2V2_ST)
    for fn in kernels:
        fn.launches = 0
    with counted_decoder_steps() as steps:
        text, stats, wall = cli_generate(fx, work / "w2v2_st_cli", "tst_wave",
                                         ["--batch-size", str(CLI_BATCH), "--dtype", "bfloat16"],
                                         path=path)
        torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in kernels}
    hyps, full, last = parse_protocol(text)
    batches = -(-CLI_WAVS // CLI_BATCH)
    implied = {"encoder_attention": 24 * batches, "conv_tail": 6 * batches,
               "decode_attention": 6 * steps[0], "logmel": 0}
    log(f"w2v2_st_cli: {path.stat().st_size / 1e6:.0f} MB .ckpt ({W2V2_ST}) through "
        f"cli.generate, bf16: {stats['sentences']} sentences in {wall:.1f} s (decode "
        f"{stats['decode_s']:.2f} s, {stats['sentences'] / stats['decode_s']:.2f} sentences/s, "
        f"load {stats['load_s']:.2f} s), {steps[0]} decoder steps; launches {counts}; {last}")
    if (counts != implied or len(full) != CLI_WAVS or steps[0] == 0
            or any(not np.isfinite(h[0][0]) for h in hyps.values())):
        raise AssertionError(f"w2v2_st_cli: launches {counts} (want {implied}), {len(full)} "
                             "samples")
    path.unlink()
    return counts


# full width (512, 16 heads of 32), depth cut from 12 layers to 4
LM_WIDE = {"lm_fusion_gbw": ({"arch": "transformer_lm_gbw", "layers": 2}, 43),  # 4 -> 2: time
           # full width (3072, 32 heads of 96), depth cut from 72 layers to 2
           "lm_fusion_megatron": ({"arch": "transformer_lm_megatron", "layers": 2}, 47)}


def lm_layers(model_cfg: dict) -> int:
    from chimera_st_tpu_torch.models.transformer_mt import ARCHITECTURES

    return ARCHITECTURES[model_cfg["arch"]][1](dict(model_cfg))["layers"]


def phase_lm_fusion_wide(torch, fx, mt_ckpt: Path, kernels):
    """``--lm-path`` with an LM of head dim 32 (transformer_lm_gbw at full
    width, 512 / 16 heads, 4 of its 12 layers) and of head dim 96 (transformer_lm_megatron
    at full width, 2 of its 72 layers), fused into ``mt_ckpt`` (the family
    phases pass transformer_iwslt_de_en) as phase_family_serve runs it: fp32 card vs CPU token-identical, bf16
    with K3 6 + the LM's layers a decoder step. Returns the launches."""
    counts = {}
    for name, (cfg, seed) in LM_WIDE.items():
        ckpt = family_checkpoint(torch, fx, name, cfg, seed)
        counts[name] = phase_family_serve(torch, fx, name, mt_ckpt, kernels, 6 + lm_layers(cfg),
                                          ["--lm-path", str(ckpt), "--lm-weight", "0.3"],
                                          profile=False)
        ckpt.unlink()
    return counts


def ensure_sacrebleu(work: Path) -> None:
    """BLEU validation (``--best-checkpoint-metric bleu``) scores through
    sacrebleu as the JAX trainer does. Where the package is not installed
    (the card's machine), a stand-in module under ``work`` gives its
    ``corpus_bleu`` (13a tokenization, n-grams up to 4, the brevity penalty,
    no smoothing of zero counts) so that the validation path runs."""
    import importlib.util

    if importlib.util.find_spec("sacrebleu") is not None:
        return
    shim = work / "shim"
    shim.mkdir(parents=True, exist_ok=True)
    (shim / "sacrebleu.py").write_text('''"""Corpus BLEU with 13a tokenization: a stand-in for sacrebleu."""
import math
import re
from collections import Counter


def _tok13a(line):
    line = " " + line.replace("&quot;", '"').replace("&amp;", "&").replace("&lt;", "<") \\
        .replace("&gt;", ">") + " "
    line = re.sub(r"([\\{-\\~\\[-\\` -\\&\\(-\\+\\:-\\@\\/])", r" \\1 ", line)
    line = re.sub(r"([^0-9])([\\.,])", r"\\1 \\2 ", line)
    line = re.sub(r"([\\.,])([^0-9])", r" \\1 \\2", line)
    line = re.sub(r"([0-9])(-)", r"\\1 \\2 ", line)
    return line.split()


class BLEU:
    def __init__(self, counts, totals, sys_len, ref_len):
        self.counts, self.totals, self.sys_len, self.ref_len = counts, totals, sys_len, ref_len
        if min(totals) == 0 or min(counts) == 0:
            self.score = 0.0
        else:
            logp = sum(math.log(c / t) for c, t in zip(counts, totals)) / 4
            bp = 1.0 if sys_len > ref_len else math.exp(1 - ref_len / max(sys_len, 1))
            self.score = 100 * bp * math.exp(logp)

    def format(self):
        return f"BLEU = {self.score:.2f} (stand-in for sacrebleu)"


def corpus_bleu(hyps, refs, tokenize="13a", lowercase=False, **_):
    counts, totals, sys_len, ref_len = [0] * 4, [0] * 4, 0, 0
    for h, r in zip(hyps, refs[0]):
        h, r = (s.lower() if lowercase else s for s in (h, r))
        ht, rt = _tok13a(h), _tok13a(r)
        sys_len, ref_len = sys_len + len(ht), ref_len + len(rt)
        for n in range(1, 5):
            hg = Counter(tuple(ht[i:i + n]) for i in range(len(ht) - n + 1))
            rg = Counter(tuple(rt[i:i + n]) for i in range(len(rt) - n + 1))
            counts[n - 1] += sum(min(c, rg[g]) for g, c in hg.items())
            totals[n - 1] += max(len(ht) - n + 1, 0)
    return BLEU(counts, totals, sys_len, ref_len)
''')
    sys.path.insert(0, str(shim))
    log("sacrebleu is not installed here: BLEU validation scores through a stand-in module "
        "(13a tokenization, corpus BLEU-4 without smoothing)")


def family_step_parity(torch, label, task, model_cfg, crit_cfg, micro, opt_cfg=None, lr=1e-4,
                       clip=0.0, keys=("loss", "nll_loss"), prepare=None):
    """One accumulated update of a family model at full width in fp32 (TF32
    off), every dropout 0, on the card (kernels) and on the CPU (plain
    versions), from the same seeded weights: the optimizer ``opt_cfg``
    (Adam (0.9, 0.98) by default) at a fixed ``lr``, ``clip`` the global
    norm; ``prepare(model)`` runs on each model before its step. Adam's
    update is held by compare_step, another optimizer's by gradient_gates
    and optimizer_step_parity."""
    import copy

    from chimera_st_tpu_torch.convert import checkpoint_axes
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.train import TrainStep

    opt_cfg = opt_cfg or {"_name": "adam", "adam_betas": "(0.9, 0.98)"}
    seeded = drawn_on_card(torch, task.build_model(
        dict(model_cfg, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0),
        device="cuda", train=True), 19)
    if prepare is not None:
        prepare(seeded)
    models = {"cpu": copy.deepcopy(seeded).to("cpu"), "cuda": seeded}
    del seeded
    out = {}
    for device in ("cuda", "cpu"):
        model = models.pop(device)
        step = TrainStep(model, task.build_criterion(crit_cfg),
                         build_optimizer(opt_cfg, list(model.parameters()), clip_norm=clip,
                                         checkpoint_axes=checkpoint_axes(model)),
                         build_lr_schedule({"_name": "fixed", "lr": lr}),
                         compute_dtype=torch.float32)
        before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        t0 = time.perf_counter()
        metrics = step(micro)
        log(f"  {label} parity {device}: {time.perf_counter() - t0:.2f} s, loss "
            f"{metrics['loss']:.4f}, gnorm {metrics['gnorm']:.4f}")
        out[device] = (metrics, before, {k: p.grad.cpu() for k, p in model.named_parameters()},
                       {k: p.detach().cpu() for k, p in model.named_parameters()})
        del model, step
    (mg, before, gg, pg), (mc, _, gc, pc) = out["cuda"], out["cpu"]
    torch.cuda.empty_cache()
    if opt_cfg["_name"] == "adam":
        return compare_step(torch, label, (mg, gg, pg), (mc, gc, pc), before, keys, lr=lr)
    rec, _ = gradient_gates(torch, label, mg, mc, gg, gc, keys, list(gc))
    rec.update(optimizer_step_parity(label, before, pg, pc, gg, gc))
    return rec


FAMILY_TRAIN_PAIRS = 1600  # about 30 updates an epoch at --max-tokens 4096
FAMILY_TRAIN_UPDATES = (10, 12)  # run A to 10, run B resumed to 12 (cut from 20 for the
# script's time limit)
FAMILY_TRAIN_MODEL = {"arch": "transformer"}  # 512 / 2048 / 8 heads, 6 + 6 layers
LM_TRAIN_MODEL = {"arch": "transformer_lm_gpt"}  # 12 x 768, 12 heads, GELU


def model_flags(model_cfg: dict):
    """``--arch`` and a flag for each other field of ``model_cfg``."""
    return [x for k, v in model_cfg.items()
            for x in (f"--{k.replace('_', '-')}", str(v))]


def family_train_fixture(fx) -> Path:
    """FAMILY_TRAIN_PAIRS more seeded en -> de pairs (the family fixture's
    Zipf law and lengths) as a ``train`` split, with the fixture's ``valid``
    pairs, binarized on its joined dictionary."""
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(53)
    n_words = FAMILY_VOCAB - 4
    words = np.asarray([f"s{i}" for i in range(n_words)])
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    raw = fx["root"] / "raw"
    src, _ = zipf_rows(rng, words, p, FAMILY_TRAIN_PAIRS)
    tgt = [" ".join(words[rng.choice(n_words, size=max(1, int(round(
        len(line.split()) * rng.uniform(0.8, 1.2)))), p=p)]) for line in src]
    (raw / "train.en").write_text("\n".join(src) + "\n")
    (raw / "train.de").write_text("\n".join(tgt) + "\n")
    out = fx["root"] / "mt_train"
    preprocess.main(["-s", "en", "-t", "de", "--joined-dictionary", "--srcdict",
                     str(fx["root"] / "dict.txt"), "--trainpref", str(raw / "train"),
                     "--validpref", str(raw / "valid"), "--destdir", str(out)])
    return out


def family_train_argv(data: Path, save_dir: Path, max_update: int, extra=()):
    """fairseq's Transformer recipe on WMT'16 en-de (``transformer`` base,
    label smoothing 0.1, Adam (0.9, 0.98), inverse_sqrt lr 5e-4, --max-tokens
    4096), bf16, the warm-up cut to 4 updates so that parameters move; BLEU
    validation as the checkpoint metric; a save at update 10."""
    return [str(data), "--task", "translation", "-s", "en", "-t", "de",
            *model_flags(FAMILY_TRAIN_MODEL), "--criterion", "label_smoothed_cross_entropy", "--label-smoothing", "0.1",
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-4",
            "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4", "--max-tokens", "4096",
            "--dtype", "bfloat16", "--max-update", str(max_update),
            "--save-interval-updates", str(FAMILY_TRAIN_UPDATES[0]),
            "--best-checkpoint-metric", "bleu", "--maximize-best-checkpoint-metric",
            "--save-dir", str(save_dir), *extra]


def phase_family_train(torch, fx, kernels):
    """``cli.train --task translation --arch transformer`` (512 / 2048 / 8
    heads, 6 + 6 layers, attention dropout 0: K1 forward in each encoder
    layer of every micro-batch, with the plain backward) on the seeded
    family text, bf16: run A to update 10 (a save and BLEU validation there,
    and at the stop), run B resumed from A's checkpoint_last to update 12
    under ``--profile``; then ``cli.validate`` on B's checkpoint without
    ``--arch`` (the stored arch is kept), ``cli.generate`` from it, and the
    fp32 card-vs-CPU parity of one accumulated step. Launches exact: K1 6 a
    training micro-batch, 6 a validation batch and 6 a BLEU decode batch, K3
    6 a decoder step of the BLEU decode. Returns the launches; prints
    {"family_train": {...}}."""
    import itertools

    from chimera_st_tpu_torch.checkpoint.store import read_state
    from chimera_st_tpu_torch.cli import generate, train, validate
    from chimera_st_tpu_torch.tasks import setup_task

    data = family_train_fixture(fx)
    task = setup_task({"_name": "translation", "data": str(data), "source_lang": "en",
                       "target_lang": "de"})
    task.load_dataset("train")
    task.load_dataset("valid")
    per_epoch = len(task.make_batch_iterator(task.dataset("train"), max_tokens=4096))
    n_valid = len(task.make_batch_iterator(task.dataset("valid"), max_tokens=4096))
    src_tokens = int(task.dataset("train").src_sizes.sum())
    tgt_tokens = int(task.dataset("train").tgt_sizes.sum())
    log(f"family_train: cli.train --arch transformer, bf16, {FAMILY_TRAIN_PAIRS} pairs "
        f"({src_tokens} / {tgt_tokens} subwords) in {per_epoch} micro-batches of at most 4096 "
        f"tokens an epoch, one an update; {n_valid} validation batch(es)")
    if per_epoch <= FAMILY_TRAIN_UPDATES[1]:
        raise AssertionError(f"family_train: {per_epoch} updates an epoch, the runs stay in one")
    save_dir = fx["root"] / "family_train"
    trace_dir = fx["root"] / "family_train_trace"
    runs, counts, rec = {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for label, max_update in zip("AB", FAMILY_TRAIN_UPDATES):
        for fn in kernels:
            fn.launches = 0
        extra = ["--profile", str(trace_dir)] if label == "B" else []
        t0 = time.perf_counter()
        with counted_decoder_steps() as steps:
            out = train.main(family_train_argv(data, save_dir, max_update, extra))
        torch.cuda.synchronize()
        counts[label] = {fn.__name__: fn.launches for fn in kernels}
        t = out["times"]
        updates = out["trainer"].num_updates - t["restored"]["step"]
        implied = {"encoder_attention": 6 * updates + 12 * n_valid * len(t["valid_s"]),
                   "conv_tail": 0, "decode_attention": 6 * steps[0], "logmel": 0}
        log(f"  run {label}: {time.perf_counter() - t0:.1f} s, step {t['restored']['step']} -> "
            f"{out['trainer'].num_updates}; epoch {[round(s, 2) for s in t['epoch_s']]} s; "
            f"saves {[round(s, 2) for s in t['save_s']]} s, validations "
            f"{[round(s, 2) for s in t['valid_s']]} s (BLEU {[round(v, 3) for v in t['valid']]}),"
            f" load {t['load_s']:.2f} s; {steps[0]} decoder steps; launches {counts[label]}")
        if counts[label] != implied or updates != max_update - t["restored"]["step"] \
                or not steps[0]:
            raise AssertionError(f"family_train run {label}: launches {counts[label]} (want "
                                 f"{implied}), {updates} updates")
        runs[label] = {"times": t, "updates": updates}
        del out
    a, b = runs["A"]["times"], runs["B"]["times"]
    last = save_dir / "checkpoint_last.ckpt"
    payload = read_state(str(last))
    if (b["restored"]["step"] != FAMILY_TRAIN_UPDATES[0] or payload["step"]
            != FAMILY_TRAIN_UPDATES[1] or payload["extra"]["model_cfg"]["arch"] != "transformer"
            or payload["opt_state"] is None):
        raise AssertionError(f"family_train: B restored at {b['restored']['step']}, saved step "
                             f"{payload['step']}")
    del payload
    busy = trace_busy(trace_dir / "trace.json")
    peak = torch.cuda.max_memory_allocated()
    # the rates after run A's first update, from the seconds of each update
    # (validations and saves excluded): run B's are under --profile
    after_first = a["update_s"][1:]
    rate = len(after_first) / sum(after_first)
    rec.update(updates_per_s_after_first=rate,
               source_tokens_per_s=src_tokens / per_epoch * rate,
               target_tokens_per_s=tgt_tokens / per_epoch * rate,
               update_s={"A": a["update_s"], "B": b["update_s"]},
               epoch_s={"A": a["epoch_s"], "B": b["epoch_s"]}, updates_per_epoch=per_epoch,
               save_s=a["save_s"] + b["save_s"], checkpoint_bytes=last.stat().st_size,
               resume_load_s=b["load_s"], valid_s=a["valid_s"] + b["valid_s"],
               valid_bleu=a["valid"] + b["valid"], peak_memory_gb=peak / 1e9,
               profile_run_b=busy, launches=counts)
    log(f"  run A: {rate:.3f} updates/s over its {len(after_first)} updates after the first "
        f"(validations and saves excluded), {rec['source_tokens_per_s']:.0f} / "
        f"{rec['target_tokens_per_s']:.0f} source / target tokens/s (the epoch's mean a "
        f"batch); peak {peak / 1e9:.2f} GB; checkpoint {rec['checkpoint_bytes'] / 1e9:.3f} GB; "
        f"run B under --profile: device busy {100 * busy['busy_share']:.1f} % of "
        f"{busy['wall_ms'] / 1e3:.1f} s")

    # cli.validate without --arch, cli.generate
    for fn in kernels:
        fn.launches = 0
    vstats = validate.main([str(data), "--task", "translation", "-s", "en", "-t", "de",
                            "--path", str(last), "--valid-subset", "valid", "--max-tokens", "4096",
                            "--criterion", "label_smoothed_cross_entropy", "--label-smoothing",
                            "0.1", "--dtype", "bfloat16"])
    torch.cuda.synchronize()
    vcounts = {fn.__name__: fn.launches for fn in kernels}
    if vcounts["encoder_attention"] != 6 * n_valid or not np.isfinite(vstats["loss"]):
        raise AssertionError(f"family_train validate: {vstats}, launches {vcounts}")
    for fn in kernels:
        fn.launches = 0
    out_dir = fx["root"] / "family_train_decode"
    out_dir.mkdir()
    with counted_decoder_steps() as steps:
        gstats = generate.main([str(data), "--task", "translation", "-s", "en", "-t", "de",
                                "--path", str(last), "--gen-subset", "valid", *FAMILY_DECODE,
                                "--batch-size", str(FAMILY_PARITY_PAIRS), "--dtype", "bfloat16",
                                "--scoring", "bleu", "--results-path", str(out_dir)])
        torch.cuda.synchronize()
    gcounts = {fn.__name__: fn.launches for fn in kernels}
    _, full, line = parse_protocol((out_dir / "generate-valid.txt").read_text())
    if (len(full) != FAMILY_PARITY_PAIRS or gcounts["encoder_attention"] != 6
            or gcounts["decode_attention"] != 6 * steps[0]):
        raise AssertionError(f"family_train generate: {len(full)} samples, launches {gcounts}")
    log(f"  cli.validate without --arch: {vstats}; cli.generate: {gstats['sentences']} "
        f"sentences, {steps[0]} decoder steps, launches {gcounts}; {line}")
    rec.update(validate=vstats, launches_validate=vcounts, launches_generate=gcounts)

    # fp32 parity of one accumulated step at full width
    micro = list(itertools.islice(task.make_batch_iterator(
        task.dataset("train"), max_sentences=8).next_epoch_itr(shuffle=False), 2))
    rec["parity"] = family_step_parity(
        torch, "family_train", task, FAMILY_TRAIN_MODEL,
        {"_name": "label_smoothed_cross_entropy", "label_smoothing": 0.1}, micro)
    import shutil

    for d in (save_dir, trace_dir, out_dir):
        shutil.rmtree(d)
    print(json.dumps({"family_train": rec}), flush=True)
    return {"family_train": {k: counts["A"][k] + counts["B"][k] for k in counts["A"]},
            "family_train_validate": vcounts, "family_train_generate": gcounts}


LM_TRAIN_UPDATES = 10


def phase_lm_train(torch, fx, kernels):
    """``cli.train --task language_modeling --arch transformer_lm_gpt
    --criterion lm_cross_entropy`` (12 x 768, 12 heads, GELU) on the seeded
    stream, --tokens-per-sample 512, --max-tokens 4096 (8 blocks a
    micro-batch), bf16, LM_TRAIN_UPDATES updates; then ``cli.eval_lm`` on
    the result, and the fp32 card-vs-CPU parity of one accumulated step (2
    micro-batches of one block). The forward is causal: no kernel launches,
    which the phase asserts. Returns the launches; prints
    {"lm_train": {...}}."""
    import itertools
    import shutil

    from chimera_st_tpu_torch.cli import eval_lm, train
    from chimera_st_tpu_torch.tasks import setup_task

    save_dir = fx["root"] / "lm_train"
    argv = [str(fx["lm"]), "--task", "language_modeling", *model_flags(LM_TRAIN_MODEL),
            "--criterion", "lm_cross_entropy", "--tokens-per-sample", str(LM_BLOCK),
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-4",
            "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4",
            "--max-tokens", str(8 * LM_BLOCK),
            "--dtype", "bfloat16", "--max-update", str(LM_TRAIN_UPDATES), "--train-subset",
            "test", "--valid-subset", "valid", "--no-epoch-checkpoints", "--save-dir",
            str(save_dir)]
    log(f"lm_train: cli.train --arch transformer_lm_gpt --criterion lm_cross_entropy, bf16, "
        f"{LM_TRAIN_UPDATES} updates of 8 blocks of {LM_BLOCK} tokens")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.main(argv)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in kernels}
    t = out["times"]
    peak = torch.cuda.max_memory_allocated()
    n_updates = out["trainer"].num_updates
    del out
    # the rates after the first update, from the seconds of each update
    after_first = t["update_s"][1:]
    rate = len(after_first) / sum(after_first)
    rec = {"updates_per_s_after_first": rate, "tokens_per_s": 8 * LM_BLOCK * rate,
           "update_s": t["update_s"], "epoch_s": t["epoch_s"],
           "save_s": t["save_s"], "valid_s": t["valid_s"], "valid_loss": t["valid"],
           "peak_memory_gb": peak / 1e9, "launches": counts,
           "wall_s": time.perf_counter() - t0}
    log(f"  {n_updates} updates; after the first {rate:.3f} updates/s, "
        f"{rec['tokens_per_s']:.0f} tokens/s; peak {peak / 1e9:.2f} GB; validation "
        f"{t['valid']}; launches {counts}")
    if any(counts.values()) or n_updates != LM_TRAIN_UPDATES \
            or not all(np.isfinite(v) for v in t["valid"]):
        raise AssertionError(f"lm_train: launches {counts}, {n_updates} updates")
    ev = eval_lm.main([str(fx["lm"]), "--path", str(save_dir / "checkpoint_last.ckpt"),
                       "--tokens-per-sample", str(LM_BLOCK), "--gen-subset", "valid",
                       "--batch-size", "8", "--dtype", "bfloat16"])
    if not np.isfinite(ev["loss_bits"]) or any(fn.launches for fn in kernels):
        raise AssertionError(f"lm_train eval_lm: {ev}")
    rec["eval_lm"] = ev
    shutil.rmtree(save_dir)
    task = setup_task({"_name": "language_modeling", "data": str(fx["lm"]),
                       "tokens_per_sample": LM_BLOCK})
    task.load_dataset("valid")
    micro = list(itertools.islice(task.make_batch_iterator(
        task.dataset("valid"), max_sentences=1).next_epoch_itr(shuffle=False), 2))
    rec["parity"] = family_step_parity(torch, "lm_train", task, LM_TRAIN_MODEL,
                                       {"_name": "lm_cross_entropy"}, micro)
    if any(fn.launches for fn in kernels):
        raise AssertionError("lm_train: the causal LM step launched a kernel")
    print(json.dumps({"lm_train": rec}), flush=True)
    return counts


TTS_PAIRS = 8


def phase_tts_update(torch, fx, kernels):
    """``translation_tts``: TTS_PAIRS seeded text pairs over the CLI
    fixture's 10,000-word dictionaries, each row with a seeded wav of 2-6 s
    named by its index, binarized by the port's preprocess; one batch of
    TTS_PAIRS (the triplet schema, audio padded to a multiple of 1280) as
    one update of the train phase's flagship (triplet criterion, Adam,
    bf16): finite, K2 6 and K1 0 (attention dropout 0.1)."""
    from chimera_st_tpu_torch.cli import preprocess
    from chimera_st_tpu_torch.data.audio import write_wav
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    root = fx["root"] / "tts"
    raw, wavs = root / "raw", root / "wavs"
    raw.mkdir(parents=True)
    wavs.mkdir()
    rng = np.random.default_rng(59)
    words = [f"w{i}" for i in range(10000 - 4)]
    for lang in ("en", "de"):
        (raw / f"train.{lang}").write_text("".join(
            " ".join(rng.choice(words, size=int(rng.integers(5, 25)))) + "\n"
            for _ in range(TTS_PAIRS)))
    for i in range(TTS_PAIRS):
        n = int(rng.integers(2 * 16000, 6 * 16000))
        write_wav(str(wavs / f"{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32))
    preprocess.main(["-s", "en", "-t", "de", "--srcdict", str(fx["root"] / "src_dict.txt"),
                     "--tgtdict", str(fx["root"] / "dict.txt"), "--trainpref",
                     str(raw / "train"), "--destdir", str(root / "bin")])
    task = setup_task({"_name": "translation_tts", "data": str(root / "bin"),
                       "source_lang": "en", "target_lang": "de", "audio_dirname": str(wavs)})
    task.load_dataset("train")
    batch = next(iter(task.make_batch_iterator(task.dataset("train"), max_sentences=TTS_PAIRS)
                      .next_epoch_itr(shuffle=False)))
    if "audio" not in batch or batch["audio"].shape[1] % 1280 or "src_text" not in batch:
        raise AssertionError(f"translation_tts batch without the triplet schema: {list(batch)}")
    model = train_model(torch, task, "cuda")
    step = TrainStep(model, task.build_criterion(TRAIN_CRITERION),
                     build_optimizer(TRAIN_ADAM, model.parameters()),
                     build_lr_schedule({"_name": "inverse_sqrt", "lr": 1e-4,
                                        "warmup_updates": 4}), compute_dtype=torch.bfloat16)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    m = step([batch])
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in kernels}
    implied = {"encoder_attention": 0, "conv_tail": 6, "decode_attention": 0, "logmel": 0}
    log(f"tts_update: translation_tts batch of {TTS_PAIRS} ({batch['audio'].shape[1] / 16000:.2f}"
        f" s padded), one flagship update in {time.perf_counter() - t0:.2f} s: loss "
        f"{m['loss']:.2f} (st {m['st_loss']:.2f}, mt {m['mt_loss']:.2f}), gnorm "
        f"{m['gnorm']:.4f}; launches {counts}")
    if counts != implied or not np.isfinite(m["loss"]) or m["nonfinite_grad"]:
        raise AssertionError(f"tts_update: launches {counts} (want {implied}), {m}")
    del step, model
    torch.cuda.empty_cache()
    return counts


# ---- joint MT + ST training, the other optimizers and
# schedules, the adaptive-softmax and character-input LMs, fusing an
# adaptive LM

JOINT_MT_PAIRS = 48  # 6 MT batches of 8 at sample ratio 0.5: 3 an epoch beside 3 ST ones
JOINT_UPDATES = (6, 8)  # run A to 6 (two epochs of 3 updates), run B resumed to 8 (cut from 10)
JOINT_KEYS = ("loss", "st_loss", "mt_loss", "contrastive_loss", "nll_loss")


def joint_fixture(fx) -> dict:
    """The CLI fixture's 24 wavs as the ST sub-task's ``train`` and ``valid``
    splits, JOINT_MT_PAIRS seeded MT pairs (and 8 valid ones) over its two
    10,000-word dictionaries binarized by the port's preprocess (source on
    src_dict.txt, target on dict.txt: the joint target vocabulary), and the
    two sub-task configs as JSON: ST (triplet, its criterion the recipe's),
    MT (translation, label-smoothed CE 0.1) at sample ratio 0.5 and weight
    0.5, as tests/test_joint_task.py configures them."""
    from chimera_st_tpu_torch.cli import preprocess

    root = fx["root"]
    for split in ("train", "valid"):
        (root / f"{split}.tsv").write_text((root / "tst_wave.tsv").read_text())
    raw = root / "joint_raw"
    raw.mkdir()
    rng = np.random.default_rng(61)
    words = [f"w{i}" for i in range(10000 - 4)]
    for split, n in (("train", JOINT_MT_PAIRS), ("valid", 8)):
        for lang in ("en", "de"):
            (raw / f"{split}.{lang}").write_text("".join(
                " ".join(rng.choice(words, size=int(rng.integers(5, 25)))) + "\n"
                for _ in range(n)))
    preprocess.main(["-s", "en", "-t", "de", "--srcdict", str(root / "src_dict.txt"),
                     "--tgtdict", str(root / "dict.txt"), "--trainpref", str(raw / "train"),
                     "--validpref", str(raw / "valid"), "--destdir", str(root / "joint_mt")])
    configs = []
    for cfg in ({"task_name": "st", "sample_ratio": 1.0, "weight": 1.0,
                 "task": {"_name": "triplet", "data": str(root),
                          "config_yaml": "config_wave.yaml"},
                 "criterion": dict(TRAIN_CRITERION, loss_ratio=[1.0, 1.0, 1.0])},
                {"task_name": "mt", "sample_ratio": 0.5, "weight": 0.5,
                 "task": {"_name": "translation", "data": str(root / "joint_mt"),
                          "source_lang": "en", "target_lang": "de"},
                 "criterion": {"_name": "label_smoothed_cross_entropy",
                               "label_smoothing": 0.1}}):
        path = root / f"joint_{cfg['task_name']}.json"
        path.write_text(json.dumps(cfg))
        configs.append(str(path))
    return dict(configs=configs, task_cfg={"_name": "joint_task_mtst", "main_task": "st",
                                           "task_configs": configs})


def joint_argv(fx, jfx, w2v2: Path, save_dir: Path, max_update: int, extra=()):
    """train_cli's recipe flags and cuts (recipes/train-en2any-ST.sh) with the
    joint task: both sub-tasks' configs, the ST one the main task,
    micro-batches of 8, 2 an update (so that updates mix ST and MT), the
    validation and the saves at the end of a run."""
    argv = train_cli_argv(fx, w2v2, save_dir, max_update)
    values = {"--task": "joint_task_mtst", "--update-freq": "2", "--train-subset": "train",
              "--valid-subset": "valid"}
    for flag, value in values.items():
        argv[argv.index(flag) + 1] = value
    return argv + ["--task-configs", *jfx["configs"], "--main-task", "st",
                   "--validate-interval", "100", "--save-interval", "100", *extra]


def joint_schedule(jfx, epochs):
    """The joint iterator's micro-batches of ``epochs`` as the train CLI
    draws them (--seed 1, --batch-size 8, --max-tokens 2000000): [(epoch,
    task_name, audio seconds, target tokens)]."""
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task(dict(jfx["task_cfg"]))
    task.load_dataset("train")
    out = []
    for epoch in epochs:
        for b in task.make_joint_iterator("train", max_tokens=2000000, max_sentences=8, seed=1,
                                          epoch=epoch):
            audio = float((~b["audio_padding_mask"]).sum()) / 16000 if "audio" in b else 0.0
            out.append((epoch, b["task_name"], audio, float(b["ntokens"])))
    return out


OPTIM_HELD_SHARE = 0.9  # the least share of elements optimizer_step_parity holds


def optimizer_step_parity(label, before, pg, pc, gg, gc, rel=1e-2):
    """The update of a non-Adam optimizer, card vs CPU: every tensor's update
    u (after - before) within ``rel`` of the CPU's in L2, plus 4 fp32
    roundings of the parameter (an update below the parameter's last place
    is rounding: compare_step allows Adam the same), over the elements
    whose gradient is the same on both devices (a row of an embedding that
    the batch does not use: 0 on both) or stands clear of the two devices'
    difference (|g| > 4 |dg|). Where it does not, a normalized first update
    (adafactor's g / sqrt(g^2), adamax's and lamb's g / (|g| + eps)) may
    take either sign on either device, as compare_step's Adam bound allows
    up to 2 lr there. The held elements must be at least OPTIM_HELD_SHARE
    of all. A key projection's bias is held against its weight's update, as
    compare_step holds gradients. Returns the largest |d| / |u| and the
    share of elements held."""
    import torch

    eps32 = torch.finfo(torch.float32).eps
    worst, worst_at, excess, clear, total = 0.0, "", [], 0, 0
    for k in pc:
        dg, dc = pg[k] - before[k], pc[k] - before[k]
        keep = (gg[k] == gc[k]) | (gc[k].abs() > 4 * (gg[k] - gc[k]).abs())
        clear, total = clear + int(keep.sum()), total + keep.numel()
        ref = pc[k[:-4] + "weight"] - before[k[:-4] + "weight"] if k.endswith("k_proj.bias") \
            else dc
        diff, scale = float(((dg - dc) * keep).norm()), float(ref.norm())
        if diff / max(scale, 1e-30) > worst:
            worst = diff / max(scale, 1e-30)
            worst_at = f"{k} (|u| {scale:.3e}, |p| {float(pc[k].norm()):.3e})"
        if diff > rel * scale + 4 * eps32 * float(pc[k].norm()):
            excess.append(f"{k} {diff:.3e} (|u| {scale:.3e}, |p| {float(pc[k].norm()):.3e})")
    log(f"  {label} every tensor's update card vs CPU over the {100 * clear / total:.4f} % of "
        f"elements whose dg = 0 or |g| > 4 |dg|: largest |d| / |u| {worst:.3e} at {worst_at}; "
        f"bound {rel:g} |u| + 4 fp32 roundings of |p|: {len(excess)} beyond")
    if excess:
        raise AssertionError(f"{label}: updates beyond the bound: {excess[:4]}")
    if clear / total < OPTIM_HELD_SHARE:
        raise AssertionError(f"{label}: the update held over {clear / total:.4f} of the "
                             f"elements, fewer than {OPTIM_HELD_SHARE}")
    return {"update_rel_max": worst, "elements_held": clear / total}


def phase_joint_train(torch, fx, work: Path, kernels):
    """Chimera's joint MT + ST fine-tune through the train CLI in-process:
    ``--task joint_task_mtst --task-configs st.json mt.json --main-task st``
    on the flagship at full width with train_cli's recipe flags and cuts,
    bf16, micro-batches of 8, 2 an update: run A from a fresh start to
    update 6 (two epochs of 3 ST and 3 MT micro-batches), run B resumed from
    A's checkpoint_last to 8, each validating the ST
    sub-task and saving at its end; then cli.generate --task triplet of B's
    checkpoint_best, and the fp32 card-vs-CPU parity of one update mixing an
    ST and an MT micro-batch. Launches exact (zeroed before each run, read
    after): K2 6 on each ST micro-batch and none on an MT one, K1 none in
    training (attention dropout 0.1), a validation batch K1 36 and K2 6; the
    decode K1 24 and K2 6 a batch, K3 6 a step. Prints {"joint_train":
    {...}}; returns the launches of the runs and of the decode."""
    import shutil

    from chimera_st_tpu_torch.checkpoint.store import read_state
    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.tasks import setup_task

    base = work / "joint_train"
    base.mkdir()
    jfx = joint_fixture(fx)
    w2v2 = w2v2_checkpoint(torch, fx, base / "wav2vec2_seeded.pt")
    save_dir = base / "checkpoints"
    sched = joint_schedule(jfx, range(1, 5))
    per_epoch = sum(1 for e, *_ in sched if e == 1)
    if per_epoch != 6 or {t for _, t, *_ in sched} != {"st", "mt"}:
        raise AssertionError(f"joint_train: {per_epoch} micro-batches an epoch, {sched}")
    updates = [sched[i:i + 2] for i in range(0, len(sched), 2)]
    mixed = sum(1 for u in updates[:JOINT_UPDATES[1]] if {m[1] for m in u} == {"st", "mt"})
    log(f"joint_train: cli.train --task joint_task_mtst (ST triplets + MT pairs at ratio 0.5, "
        f"weight 0.5), the flagship at full width, bf16; {per_epoch} micro-batches of 8 an "
        f"epoch, 2 an update; {mixed} of the {JOINT_UPDATES[1]} updates mix ST and MT")
    if not mixed:
        raise AssertionError("joint_train: no update mixes an ST and an MT micro-batch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, counts = {}, {}
    for label, max_update in zip("AB", JOINT_UPDATES):
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        out = train.main(joint_argv(fx, jfx, w2v2, save_dir, max_update))
        torch.cuda.synchronize()
        counts[label] = {fn.__name__: fn.launches for fn in kernels}
        t = out["times"]
        ran = updates[t["restored"]["step"]:out["trainer"].num_updates]
        st_micro = sum(1 for u in ran for m in u if m[1] == "st")
        valid = 3 * len(t["valid_s"])
        implied = {"encoder_attention": 36 * valid, "conv_tail": 6 * st_micro + 6 * valid,
                   "decode_attention": 0, "logmel": 0}
        log(f"  run {label}: {time.perf_counter() - t0:.1f} s, step {t['restored']['step']} -> "
            f"{out['trainer'].num_updates}, {st_micro} ST and {2 * len(ran) - st_micro} MT "
            f"micro-batches, {valid} validation batches; updates "
            f"{[round(s, 3) for s in t['update_s']]} s, saves {[round(s, 2) for s in t['save_s']]}"
            f" s, validations {[round(s, 2) for s in t['valid_s']]} s (st_loss "
            f"{[round(v, 3) for v in t['valid']]}), load {t['load_s']:.2f} s; launches "
            f"{counts[label]}")
        if counts[label] != implied or out["trainer"].num_updates != max_update \
                or not all(np.isfinite(v) for v in t["valid"]):
            raise AssertionError(f"joint_train run {label}: launches {counts[label]} (want "
                                 f"{implied}), {out['trainer'].num_updates} updates")
        runs[label] = {"times": t, "ran": ran}
        del out
        torch.cuda.empty_cache()
    a, b = runs["A"], runs["B"]
    payload = read_state(str(save_dir / "checkpoint_last.ckpt"))
    if (b["times"]["restored"]["step"] != JOINT_UPDATES[0] or payload["step"] != JOINT_UPDATES[1]
            or b["times"]["restored"]["train_iterator"] != {"epoch": 3}
            or payload["extra"]["task_cfg"]["_name"] != "joint_task_mtst"):
        raise AssertionError(f"joint_train: B restored at {b['times']['restored']}, saved step "
                             f"{payload['step']}")
    size = (save_dir / "checkpoint_last.ckpt").stat().st_size
    del payload
    peak = torch.cuda.max_memory_allocated()
    # the rates after run A's first update, from each update's seconds
    # (validations and saves excluded)
    timed, secs = a["ran"][1:], a["times"]["update_s"][1:]
    rate = len(timed) / sum(secs)
    audio_s = sum(m[2] for u in timed for m in u) / sum(secs)
    tokens_s = sum(m[3] for u in timed for m in u) / sum(secs)
    rec = {"updates_per_s_after_first": rate, "audio_s_per_s": audio_s,
           "target_tokens_per_s": tokens_s, "mixed_updates": mixed,
           "update_s": {"A": a["times"]["update_s"], "B": b["times"]["update_s"]},
           "save_s": a["times"]["save_s"] + b["times"]["save_s"], "checkpoint_bytes": size,
           "resume_load_s": b["times"]["load_s"],
           "valid_s": a["times"]["valid_s"] + b["times"]["valid_s"],
           "valid_st_loss": a["times"]["valid"] + b["times"]["valid"],
           "peak_memory_gb": peak / 1e9, "launches": counts}
    log(f"  run A after its first update: {rate:.3f} updates/s, {audio_s:.1f} audio s/s, "
        f"{tokens_s:.0f} target tokens/s (ST and MT); peak {peak / 1e9:.2f} GB; checkpoint "
        f"{size / 1e9:.2f} GB")

    # the written checkpoint decodes as an ST model
    for fn in kernels:
        fn.launches = 0
    with counted_decoder_steps() as steps:
        text, stats, wall = cli_generate(fx, base / "decode", "tst_wave",
                                         ["--batch-size", str(CLI_BATCH), "--dtype", "bfloat16"],
                                         path=save_dir / "checkpoint_best.ckpt")
        torch.cuda.synchronize()
    counts["decode"] = {fn.__name__: fn.launches for fn in kernels}
    hyps, full, last_line = parse_protocol(text)
    batches = -(-CLI_WAVS // CLI_BATCH)
    implied = {"encoder_attention": 24 * batches, "conv_tail": 6 * batches,
               "decode_attention": 6 * steps[0], "logmel": 0}
    log(f"  cli.generate --task triplet of checkpoint_best.ckpt: {stats['sentences']} sentences "
        f"in {wall:.1f} s, {steps[0]} decode steps; launches {counts['decode']}; {last_line}")
    if (len(full) != CLI_WAVS or counts["decode"] != implied or steps[0] == 0
            or any(not np.isfinite(h[0][0]) for h in hyps.values())):
        raise AssertionError(f"joint_train decode: {len(full)} samples, launches "
                             f"{counts['decode']} (want {implied})")
    rec["decode_s"] = stats["decode_s"]
    shutil.rmtree(base)

    # fp32 parity of one update mixing an ST and an MT micro-batch
    task = setup_task(dict(jfx["task_cfg"]))
    task.load_dataset("train")
    micro = {}
    for batch in task.make_joint_iterator("train", max_sentences=2, seed=1):
        micro.setdefault(batch["task_name"], batch)
    rec["parity"] = flagship_step_parity(
        torch, "joint_train", task, {"_name": "label_smoothed_cross_entropy"},
        [micro["st"], micro["mt"]], JOINT_KEYS)
    print(json.dumps({"joint_train": rec}), flush=True)
    return ({k: counts["A"][k] + counts["B"][k] for k in counts["A"]}, counts["decode"])


# optimizer or schedule -> its flags (the lr each takes at this scale); the
# schedules run under adam, as the recipes do; adafactor without --clip-norm
OPTIM_SWEEP = {
    "adam": ["--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-4"],
    "adafactor": ["--optimizer", "adafactor", "--lr", "1e-3"],
    "adagrad": ["--optimizer", "adagrad", "--lr", "1e-2"],
    "adadelta": ["--optimizer", "adadelta", "--lr", "1.0"],
    "sgd": ["--optimizer", "sgd", "--momentum", "0.9", "--lr", "1e-2"],
    "nag": ["--optimizer", "nag", "--lr", "1e-2"],
    "adamax": ["--optimizer", "adamax", "--lr", "2e-3"],
    "lamb": ["--optimizer", "lamb", "--lr", "1e-3", "--weight-decay", "0.01"],
    "cosine": ["--lr-scheduler", "cosine", "--lr", "1e-5", "--max-lr", "5e-4",
               "--lr-period-updates", "3"],
    "polynomial_decay": ["--lr-scheduler", "polynomial_decay", "--lr", "5e-4",
                         "--total-num-update", "6", "--end-learning-rate", "1e-5"],
    "tri_stage": ["--lr-scheduler", "tri_stage", "--lr", "5e-4", "--phase-ratio",
                  "(0.3, 0.3, 0.4)"],
    "triangular": ["--lr-scheduler", "triangular", "--lr", "1e-5", "--max-lr", "5e-4",
                   "--lr-period-updates", "4"],
    "reduce_lr_on_plateau": ["--lr-scheduler", "reduce_lr_on_plateau", "--lr", "5e-4",
                             "--save-interval-updates", "2"],
}
OPTIM_UPDATES = 6
# the sweep's transformer: FAMILY_TRAIN_MODEL's widths, 1 of its 6 + 6 layers
# (cut for the script's time limit)
OPTIM_MODEL = {"arch": "transformer", "encoder_layers": 1, "decoder_layers": 1}


def optim_argv(data: Path, save_dir: Path, name: str):
    flags = list(OPTIM_SWEEP[name])
    if "--optimizer" not in flags:
        flags = OPTIM_SWEEP["adam"][:4] + flags
    if "--lr-scheduler" not in flags:
        flags += ["--lr-scheduler", "inverse_sqrt"]
    if name != "adafactor":
        flags += ["--clip-norm", "0.1"]
    return [str(data), "--task", "translation", "-s", "en", "-t", "de",
            *model_flags(OPTIM_MODEL), "--criterion", "label_smoothed_cross_entropy",
            "--label-smoothing", "0.1", "--warmup-updates", "2", "--max-tokens", "4096",
            "--dtype", "bfloat16", "--max-update", str(OPTIM_UPDATES), "--no-epoch-checkpoints",
            "--save-dir", str(save_dir), *flags]


def phase_optim_sweep(torch, fx, data: Path, kernels):
    """``cli.train --task translation --arch transformer`` (family_train's
    data and widths, 2 + 2 layers: OPTIM_MODEL; bf16) for each optimizer and each schedule of
    OPTIM_SWEEP: OPTIM_UPDATES updates with the warm-up cut to 2, the
    validation and the save at the end (reduce_lr_on_plateau also every 2
    updates, so that its step_val runs); the written optimizer state loads
    back into a fresh optimizer of the same flags (the layout of the JAX
    chain, convert.OPTAX_CHAINS) equal to the trainer's bit for bit, at
    update count 6; for each optimizer one fp32 update card vs CPU on a
    micro-batch of 4 pairs (family_step_parity; adamax and lamb at eps
    1e-3), for each schedule its lr from the count on the card against the
    host's (it changes an update by its lr alone). K1 2 a
    training micro-batch and 2 a validation batch, exactly. Prints
    {"optim_sweep": {...}} (updates/s after the first update beside
    adam's); returns the launches."""
    import itertools
    import shutil

    from chimera_st_tpu_torch.checkpoint.store import read_state
    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.cli.train import optimizer_config
    from chimera_st_tpu_torch.cli.options import add_train_args, base_parser
    from chimera_st_tpu_torch.convert import checkpoint_axes
    from chimera_st_tpu_torch.optim import build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "translation", "data": str(data), "source_lang": "en",
                       "target_lang": "de"})
    task.load_dataset("train")
    task.load_dataset("valid")
    n_valid = len(task.make_batch_iterator(task.dataset("valid"), max_tokens=4096))
    micro = list(itertools.islice(task.make_batch_iterator(
        task.dataset("train"), max_sentences=4).next_epoch_itr(shuffle=False), 1))
    parser = add_train_args(base_parser("sweep"))
    rec, total = {}, None
    log(f"optim_sweep: cli.train --arch transformer, bf16, {OPTIM_UPDATES} updates each: "
        f"{', '.join(OPTIM_SWEEP)}")
    for name in OPTIM_SWEEP:
        save_dir = fx["root"] / f"optim_{name}"
        argv = optim_argv(data, save_dir, name)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        out = train.main(argv)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in kernels}
        t = out["times"]
        trainer = out["trainer"]
        layers = OPTIM_MODEL["encoder_layers"]
        implied = {"encoder_attention": layers * (OPTIM_UPDATES + n_valid * len(t["valid_s"])),
                   "conv_tail": 0, "decode_attention": 0, "logmel": 0}
        after_first = t["update_s"][1:]
        rate = len(after_first) / sum(after_first)
        # the save: the written optimizer state into a fresh optimizer
        args, _ = parser.parse_known_args(argv)
        payload = read_state(str(save_dir / "checkpoint_last.ckpt"))
        fresh = build_optimizer(optimizer_config(args), list(trainer.model.parameters()),
                                clip_norm=args.clip_norm, checkpoint_axes=checkpoint_axes(trainer.model))
        held = trainer.optimizer.state_to_optax(trainer.model, trainer.num_updates)
        count = fresh.load_optax(payload["opt_state"], trainer.model)
        back = fresh.state_to_optax(trainer.model, count)
        same = count == trainer.num_updates == OPTIM_UPDATES and all(
            np.array_equal(x, y) for x, y in zip(_leaves(back), _leaves(held)))
        lrs = [float(trainer.lr_schedule(s)) for s in range(OPTIM_UPDATES)]
        log(f"  {name}: {time.perf_counter() - t0:.1f} s, {rate:.2f} updates/s after the first, "
            f"lr {[f'{x:.3g}' for x in lrs]}, validations {len(t['valid_s'])} "
            f"{[round(v, 3) for v in t['valid']]}; the optax tree ({trainer.optimizer.layout}) "
            f"restores equal: {same}; launches {counts}")
        if counts != implied or not same or not all(np.isfinite(v) for v in t["valid"]):
            raise AssertionError(f"optim_sweep {name}: launches {counts} (want {implied}), "
                                 f"restored {same}")
        if name == "reduce_lr_on_plateau" and (len(t["valid_s"]) < 3 or
                                               "lr_scheduler" not in payload["extra"]):
            raise AssertionError("optim_sweep reduce_lr_on_plateau: no step_val")
        if "--lr-scheduler" in OPTIM_SWEEP[name]:
            # a schedule changes an update by its lr alone (adam's step is held
            # below): its value from the count on the card against the host's
            sched = trainer.lr_schedule
            on_card = sched(torch.arange(OPTIM_UPDATES, device="cuda")).cpu().numpy()
            check(f"optim_sweep {name}: the schedule at counts 0..{OPTIM_UPDATES - 1} on the "
                  "card vs the host's (relative)",
                  float(np.max(np.abs(on_card - np.asarray(lrs)) / np.maximum(lrs, 1e-30))),
                  1e-12)
            parity = None
        else:
            opt_cfg = optimizer_config(args)
            if name in ("adamax", "lamb"):
                # eps 1e-3 bounds the slope of their first update in g (an Adam-like
                # g / (|g| + eps), as tests/test_torch_train.py raises adam_eps)
                opt_cfg[f"{name}_eps"] = 1e-3
            parity = family_step_parity(
                torch, f"optim_sweep {name}", task, OPTIM_MODEL,
                {"_name": "label_smoothed_cross_entropy", "label_smoothing": 0.1}, micro,
                opt_cfg, lrs[-1], args.clip_norm)
        rec[name] = {"updates_per_s_after_first": rate, "update_s": t["update_s"],
                     "lr": lrs, "layout": trainer.optimizer.layout,
                     "valid_loss": t["valid"], "parity": parity, "launches": counts}
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        del out, trainer, payload, fresh
        shutil.rmtree(save_dir)
        torch.cuda.empty_cache()
    adam = rec["adam"]["updates_per_s_after_first"]
    log("  updates/s beside adam's: " + ", ".join(
        f"{k} {v['updates_per_s_after_first'] / adam:.2f}" for k, v in rec.items()))
    print(json.dumps({"optim_sweep": rec}), flush=True)
    return total


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], path + (k,))
        return out
    return [np.asarray(tree)]


# fairseq's wikitext-103 vocabulary size (its adaptive-input LM's dictionary)
WIKI103_VOCAB = 267744
WIKI103_BLOCK = 3072  # the recipe's --tokens-per-sample
WIKI103_STREAM = 6 * WIKI103_BLOCK + 2000
WIKI103_UPDATES = 5
# 1024 wide, 8 heads, cutoffs 20000 / 60000; 4 of its 16 layers (cut for the time limit)
WIKI103_MODEL = {"arch": "transformer_lm_wiki103", "layers": 4}
CHAR_LM_MODEL = {"arch": "transformer_lm_gbw", "character_embeddings": True}
# fairseq's wiki103 recipe: nag, lr 1e-4, clip 0.1, cosine to max_lr 1 with
# t_mult 2; the warm-up (16,000) and the period (270,000) cut to this run
WIKI103_OPT = ["--optimizer", "nag", "--lr", "1e-4", "--clip-norm", "0.1",
               "--lr-scheduler", "cosine", "--max-lr", "1.0", "--t-mult", "2",
               "--lr-period-updates", "4", "--warmup-updates", "2", "--warmup-init-lr", "1e-7"]


def make_wiki103_fixture(root: Path, seed: int = 67) -> dict:
    """A dictionary of WIKI103_VOCAB words (Zipf counts) and a seeded Zipf
    stream of WIKI103_STREAM tokens (``test``; its first 2 blocks also as
    ``valid``), binarized by the port's preprocess --only-source."""
    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(seed)
    n_words = WIKI103_VOCAB - 4
    words = np.asarray([f"v{i}" for i in range(n_words)])
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    raw = root / "raw"
    raw.mkdir(parents=True)
    rows, n = [], 0
    while n < WIKI103_STREAM:
        r, ids = zipf_rows(rng, words, p, 64)
        rows += r
        n += len(ids) + 64
    head, n_head = [], 0
    for row in rows:
        if n_head >= 2 * WIKI103_BLOCK:
            break
        head.append(row)
        n_head += len(row.split()) + 1
    (raw / "lm.txt").write_text("\n".join(rows) + "\n")
    (raw / "lm_head.txt").write_text("\n".join(head) + "\n")
    dict_file = root / "dict.txt"
    dict_file.write_text("".join(f"{w} {int(1e9 * q) + 1}\n" for w, q in zip(words, p)))
    preprocess.main(["--only-source", "--srcdict", str(dict_file), "--testpref",
                     str(raw / "lm.txt"), "--validpref", str(raw / "lm_head.txt"),
                     "--destdir", str(root / "bin")])
    return dict(root=root, bin=root / "bin", tokens=n)


def lm_step_parity(torch, label, data: Path, model_cfg, crit_cfg):
    """family_step_parity on one block of 512 tokens of the stream."""
    import itertools

    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "language_modeling", "data": str(data),
                       "tokens_per_sample": 512})
    task.load_dataset("valid")
    micro = list(itertools.islice(task.make_batch_iterator(
        task.dataset("valid"), max_sentences=1).next_epoch_itr(shuffle=False), 1))
    return family_step_parity(torch, label, task, model_cfg, crit_cfg, micro)


def phase_lm_adaptive(torch, work: Path, kernels):
    """``cli.train --task language_modeling --arch transformer_lm_wiki103
    --criterion adaptive_loss`` at the preset's full width (1024, 8 heads,
    FFN 4096, adaptive softmax cutoffs 20,000 / 60,000; 4 of its 16 layers) over a
    dictionary of fairseq's wikitext-103 size, --tokens-per-sample 3072, one
    block a micro-batch, the recipe's optimizer and schedule (WIKI103_OPT),
    bf16, WIKI103_UPDATES updates; then cli.eval_lm of the result (bf16,
    3072-token blocks), the fp32 card-vs-CPU step on one block of 512, and
    one update of ``transformer_lm_gbw --character-embeddings`` (the full
    preset: 12 x 512, 16 heads, FFN 4096, characters to a 512-wide
    embedding) with its own fp32 parity step. No kernel launches: the LM is
    causal. Prints {"lm_adaptive": {...}}; returns the launches."""
    import shutil

    from chimera_st_tpu_torch.cli import eval_lm, train

    fx = make_wiki103_fixture(work / "wiki103")
    rec = {}
    for label, model, crit, extra, n_up in (
            ("wiki103", WIKI103_MODEL, "adaptive_loss", WIKI103_OPT, WIKI103_UPDATES),
            ("char_gbw", CHAR_LM_MODEL, "lm_cross_entropy", OPTIM_SWEEP["adam"], 1)):
        save_dir = fx["root"] / f"{label}_ckpt"
        argv = [str(fx["bin"]), "--task", "language_modeling", *model_flags(model),
                "--criterion", crit, "--tokens-per-sample", str(WIKI103_BLOCK),
                "--max-tokens", str(WIKI103_BLOCK), *extra, "--dtype", "bfloat16",
                "--max-update", str(n_up), "--train-subset", "test", "--valid-subset", "valid",
                "--no-epoch-checkpoints", "--no-save-optimizer-state", "--save-dir",
                str(save_dir)]
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in kernels}
        t = out["times"]
        n_params = sum(p.numel() for p in out["trainer"].model.parameters())
        n_updates = out["trainer"].num_updates
        peak = torch.cuda.max_memory_allocated()
        del out
        torch.cuda.empty_cache()
        # the rate after the first update (of a one-update run: of that update)
        after_first = t["update_s"][1:] or t["update_s"]
        rate = len(after_first) / sum(after_first)
        which = "after the first" if n_updates > 1 else "its one update"
        r = {"parameters": n_params, "updates_per_s_after_first": rate,
             "tokens_per_s": WIKI103_BLOCK * rate, "update_s": t["update_s"],
             "valid_loss": t["valid"], "save_s": t["save_s"], "peak_memory_gb": peak / 1e9,
             "wall_s": wall, "launches": counts}
        log(f"lm_adaptive {label}: {model}, {n_params / 1e6:.1f} M parameters, {n_updates} "
            f"updates of {WIKI103_BLOCK} tokens in {wall:.1f} s; {rate:.2f} updates/s "
            f"({r['tokens_per_s']:.0f} tokens/s) {which}; validation {t['valid']}; "
            f"peak {peak / 1e9:.2f} GB; launches {counts}")
        if any(counts.values()) or n_updates != n_up or not all(np.isfinite(v)
                                                                for v in t["valid"]):
            raise AssertionError(f"lm_adaptive {label}: launches {counts}, {n_updates} updates")
        if label == "wiki103":
            t0 = time.perf_counter()
            ev = eval_lm.main([str(fx["bin"]), "--path", str(save_dir / "checkpoint_last.ckpt"),
                               "--tokens-per-sample", str(WIKI103_BLOCK), "--gen-subset", "test",
                               "--batch-size", "1", "--dtype", "bfloat16"])
            torch.cuda.synchronize()
            if not np.isfinite(ev["loss_bits"]) or any(fn.launches for fn in kernels):
                raise AssertionError(f"lm_adaptive eval_lm: {ev}")
            r["eval_lm"] = dict(ev, tokens_per_s=ev["tokens"] / ev["eval_s"],
                                wall_s=time.perf_counter() - t0)
            log(f"  eval_lm: {ev['tokens']} tokens in {ev['eval_s']:.2f} s "
                f"({r['eval_lm']['tokens_per_s']:.0f} tokens/s), {ev['loss_bits']:.4f} "
                f"bits/token")
        shutil.rmtree(save_dir)
        # the character LM's parity step at 2 of its 12 layers (widths kept;
        # cut for the script's time limit: the CPU side is the cost)
        r["parity"] = lm_step_parity(torch, f"lm_adaptive {label}", fx["bin"],
                                     dict(model, layers=2) if label == "char_gbw" else model,
                                     {"_name": crit})
        if any(fn.launches for fn in kernels):
            raise AssertionError(f"lm_adaptive {label}: the causal LM launched a kernel")
        rec[label] = r
    shutil.rmtree(fx["root"])
    print(json.dumps({"lm_adaptive": rec}), flush=True)
    return {fn.__name__: 0 for fn in kernels}


# the wiki103 LM over the family's 32,768-subword dictionary: its cutoffs
# (20,000 / 60,000 for a 267,744-word vocabulary) set to fit it
# the wiki103 widths, 4 of its 16 layers (cut for the script's time limit)
LM_ADAPTIVE_FUSION = {"arch": "transformer_lm_wiki103", "adaptive_softmax_cutoffs": (8000, 20000),
                      "layers": 4}


def phase_lm_fusion_adaptive(torch, fx, mt_ckpt: Path, kernels):
    """``--lm-path`` of a transformer_lm_wiki103 LM at full width (1024, 8
    heads of 128; 4 of its 16 layers) with an adaptive softmax, fused into
    ``mt_ckpt`` (transformer_iwslt_de_en) as phase_family_serve runs it: the fused
    scores add the adaptive softmax's normalized log-probabilities; fp32
    card vs CPU token-identical, bf16 with K3 6 + 4 a decoder step (the
    LM's at head dim 128). Returns the launches."""
    ckpt = family_checkpoint(torch, fx, "lm_fusion_adaptive", LM_ADAPTIVE_FUSION, 71)
    counts = phase_family_serve(torch, fx, "lm_fusion_adaptive", mt_ckpt, kernels,
                                6 + lm_layers(LM_ADAPTIVE_FUSION),
                                ["--lm-path", str(ckpt), "--lm-weight", "0.3"], profile=False)
    ckpt.unlink()
    return {"lm_fusion_adaptive": counts}


# ---- the non-autoregressive family: the six models served by cli.generate
# --task translation_lev / translation_ins (K1 in the encoder and in every
# decoder pass over the canvas), trained by cli.train

NAT_DECODE = ["--max-decode-len", "64"]  # canvases of 64
# name -> (model config, the generate flags, task); fairseq's
# examples/nonautoregressive_translation README flags where it gives them
NAT_MODELS = {
    "levenshtein": ({"arch": "levenshtein_transformer_wmt_en_de"},
                    ["--iter-decode-max-iter", "9", "--iter-decode-eos-penalty", "0",
                     "--print-step"], "translation_lev"),
    "cmlm": ({"arch": "cmlm_transformer_wmt_en_de"},
             ["--iter-decode-max-iter", "10", "--iter-decode-with-beam", "5"], "translation_lev"),
    "nat": ({"arch": "nonautoregressive_transformer_wmt_en_de"}, [], "translation_lev"),
    "inat": ({"arch": "iterative_nonautoregressive_transformer_wmt_en_de"}, [],
             "translation_lev"),
    "nacrf": ({"arch": "nacrf_transformer"}, [], "translation_lev"),
    "insertion": ({"arch": "insertion_transformer"}, [], "translation_ins"),
}


@contextlib.contextmanager
def counted_refinement():
    """While open, notes the rounds each refinement call runs (Levenshtein,
    its ensemble and insertion share ``refine_rounds``): yields the list."""
    from chimera_st_tpu_torch.models import nat_insertion, nat_levenshtein

    rounds = []
    real = nat_levenshtein.refine_rounds

    def noted(*args, **kwargs):
        out = real(*args, **kwargs)
        rounds.append(out[3])
        return out

    nat_levenshtein.refine_rounds = nat_insertion.refine_rounds = noted
    try:
        yield rounds
    finally:
        nat_levenshtein.refine_rounds = nat_insertion.refine_rounds = real


def nat_generate(fx, task: str, ckpt: str, out_dir: Path, subset: str, extra):
    """cli.generate --task ``task`` on the family fixture -> (its output
    text, its returned counts and times)."""
    from chimera_st_tpu_torch.cli import generate

    out_dir.mkdir(parents=True, exist_ok=True)
    stats = generate.main([str(fx["mt"]), "--task", task, "-s", "en", "-t", "de", "--path",
                           ckpt, "--gen-subset", subset, *NAT_DECODE, "--scoring", "bleu",
                           "--results-path", str(out_dir), *extra])
    return (out_dir / f"generate-{subset}.txt").read_text(), stats


def nat_lines(text: str, kind: str):
    """{sample id: rest of the line} of the output's ``kind``- lines."""
    out = {}
    for line in text.splitlines():
        head, _, rest = line.partition("\t")
        if head.startswith(kind + "-") and head[len(kind) + 1:].isdigit():
            out[int(head[len(kind) + 1:])] = rest
    return out


def nat_margin(torch, fx, task_name: str, ckpt: str, sid: int, hyp: str) -> float:
    """The smallest top-2 margin of the fp32 CPU model's word logits over
    one sentence's hypothesis, teacher-forced as a canvas: how near a tie
    the prediction that differed was."""
    from chimera_st_tpu_torch.cli.generate import load_model_and_params
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": task_name, "data": str(fx["mt"]), "source_lang": "en",
                       "target_lang": "de"})
    model = load_model_and_params(ckpt, task, torch.float32, "cpu")
    d = task.target_dictionary
    src = torch.tensor([task.dataset("valid")[sid]["source"]]).long()
    canvas = torch.tensor([[0] + [d.index(w) for w in hyp.split()] + [d.eos()]]).long()
    enc, enc_mask = model.encode(src)
    with torch.no_grad():
        top = model.decode_tokens(canvas, enc, enc_mask).float().topk(2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def nat_expected_k1(name: str, n_batches: int, rounds, members: int = 1,
                    reranker: bool = False) -> int:
    """K1 launches of a NAT decode run: 6 encoder layers a batch for each
    member, and 6 decoder layers for each decoder pass that ran (Levenshtein
    3 a round, insertion 1, CMLM one an iteration over every length-beam
    candidate at once, the translate family one an iteration), plus the
    reranker's 6 encoder layers a batch."""
    if name == "levenshtein":
        passes = 3 * members * sum(rounds)
    elif name == "insertion":
        passes = sum(rounds)
    elif name == "cmlm":
        passes = 10 * n_batches
    else:
        passes = n_batches  # --iter-decode-max-iter 1
    return 6 * members * n_batches + 6 * passes + 6 * n_batches * reranker


def nat_serve_one(torch, fx, label, name, ckpts, kernels, extra=(), members=1, flags=None):
    """One NAT model through cli.generate: fp32 on the card against
    --device cpu on the ``valid`` split (FAMILY_PARITY_PAIRS sentences), hypotheses and
    step counts identical (a difference prints the sentence and its top-2
    margin, then fails); then bf16 on the ``test`` split in batches of 32
    with the launch counts zeroed before and read after, K1 exact by
    nat_expected_k1 from the rounds run. Returns (launches, record)."""
    _, default_flags, task = NAT_MODELS[name]
    flags = [*(default_flags if flags is None else flags), *extra]
    path = ":".join(ckpts)
    work = fx["root"] / f"nat_{label}"
    common = ["--batch-size", str(FAMILY_PARITY_PAIRS), "--dtype", "float32", *flags]
    t0 = time.perf_counter()
    gpu_text, _ = nat_generate(fx, task, path, work / "parity_cuda", "valid", common)
    cpu_text, _ = nat_generate(fx, task, path, work / "parity_cpu", "valid",
                               common + ["--device", "cpu"])
    gh, ch = nat_lines(gpu_text, "H"), nat_lines(cpu_text, "H")
    if len(ch) != FAMILY_PARITY_PAIRS or sorted(gh) != sorted(ch):
        raise AssertionError(f"nat {label}: samples {sorted(gh)} vs {sorted(ch)}")
    worst = 0.0
    for sid in sorted(ch):
        (g_score, _, g_hyp), (c_score, _, c_hyp) = (x[sid].partition("\t") for x in (gh, ch))
        worst = max(worst, abs(float(g_score) - float(c_score)))
        if g_hyp != c_hyp:
            margin = nat_margin(torch, fx, task, ckpts[0], sid, c_hyp)
            log(f"nat {label}: sentence {sid} differs, card vs CPU:\n  {gh[sid]}\n  "
                f"{ch[sid]}\n  smallest top-2 margin of the CPU model over it {margin:.3e}")
            raise AssertionError(f"nat {label}: fp32 card vs CPU differ at sentence {sid}")
    if nat_lines(gpu_text, "I") != nat_lines(cpu_text, "I"):
        raise AssertionError(f"nat {label}: step counts differ card vs CPU")
    # the scores: 0, or the reranker's, printed with four decimals
    check(f"nat {label}: hypotheses identical, fp32 card vs CPU; scores", worst, 2e-4)
    parity_s = time.perf_counter() - t0
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_refinement() as rounds, counted_decoder_steps() as steps:
        t0 = time.perf_counter()
        text, stats = nat_generate(fx, task, path, work / "serve", "test",
                                   ["--batch-size", str(FAMILY_BATCH), "--dtype", "bfloat16",
                                    *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    n_batches = -(-FAMILY_TEST_PAIRS // FAMILY_BATCH)
    hyps = nat_lines(text, "H")
    implied = {"encoder_attention": nat_expected_k1(
        name, n_batches, rounds, members, "--iter-decode-with-external-reranker" in flags),
        "conv_tail": 0, "decode_attention": 0, "logmel": 0}
    rec = {"sentences": stats["sentences"], "wall_s": wall, "decode_s": stats["decode_s"],
           "load_s": stats["load_s"], "sentences_per_s": stats["sentences"] / stats["decode_s"],
           "rounds": rounds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "fp32_parity_s": parity_s}
    steps_printed = nat_lines(text, "I")
    if steps_printed:
        rec["steps"] = sorted(int(v) for v in steps_printed.values())
    log(f"  nat {label}: bf16 {stats['sentences']} sentences in {wall:.1f} s (decode "
        f"{stats['decode_s']:.2f} s, {rec['sentences_per_s']:.1f} sentences/s), rounds "
        f"{rounds}; launches {counts}; fp32 card = CPU on {len(ch)} sentences")
    if (counts != implied or steps[0] or len(hyps) != FAMILY_TEST_PAIRS
            or any("nan" in h for h in hyps.values())):
        raise AssertionError(f"nat {label}: launches {counts} (want {implied}), decoder steps "
                             f"{steps[0]}, {len(hyps)} hypotheses")
    if name == "levenshtein" and steps_printed and "--iter-decode-force-max-iter" not in flags:
        # the rounds run follow the printed step counts: one past the batch's most
        batches = nat_batch_ids(fx, task)
        want = [min(9, max(int(steps_printed[i]) for i in ids) + 1) for ids in batches]
        if sorted(want) != sorted(rounds):
            raise AssertionError(f"nat {label}: rounds {rounds}, the printed steps imply {want}")
    return counts, rec


def nat_batch_ids(fx, task_name: str):
    """The sample ids of each test batch of 32, as the generate CLI batches
    them."""
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": task_name, "data": str(fx["mt"]), "source_lang": "en",
                       "target_lang": "de"})
    task.load_dataset("test")
    itr = task.make_batch_iterator(task.dataset("test"), max_sentences=FAMILY_BATCH)
    return [list(map(int, b["id"])) for b in itr.next_epoch_itr(shuffle=False)]


def phase_nat_serve(torch, fx, kernels):
    """The slice's main path: each of the six NAT models at the presets'
    full width (512 / 2048 / 8 heads, 6 + 6 layers) on the family's
    32,768-subword dictionary, a seeded ``.ckpt`` saved by the port, served
    by cli.generate (nat_serve_one); then a two-checkpoint Levenshtein
    ensemble, CMLM with --iter-decode-with-external-reranker (a
    ``transformer`` on the same dictionary as the last --path) and
    Levenshtein with --retain-iter-history; beside them the ``transformer``
    at the same width on the same batches at beam 4 and beam 1. Returns
    {run: launches}; prints {"nat_serve": {...}}."""
    ckpts = {name: str(family_checkpoint(torch, fx, f"nat_{name}", cfg, 70 + i))
             for i, (name, (cfg, _, _)) in enumerate(NAT_MODELS.items())}
    ckpts["levenshtein_b"] = str(family_checkpoint(
        torch, fx, "nat_levenshtein_b", NAT_MODELS["levenshtein"][0], 77))
    ckpts["ar"] = str(family_checkpoint(torch, fx, "nat_ar", {"arch": "transformer"}, 78))
    log(f"nat_serve: cli.generate --task translation_lev / translation_ins "
        f"{' '.join(NAT_DECODE)}; fp32 card vs CPU on {FAMILY_PARITY_PAIRS} sentences, then bf16 "
        f"on {FAMILY_TEST_PAIRS} in batches of {FAMILY_BATCH}")
    counts, recs = {}, {}
    for name in NAT_MODELS:
        counts[f"nat_{name}"], recs[name] = nat_serve_one(torch, fx, name, name, [ckpts[name]],
                                                          kernels)
    counts["nat_levenshtein_ensemble"], recs["levenshtein_ensemble"] = nat_serve_one(
        torch, fx, "levenshtein_ensemble", "levenshtein",
        [ckpts["levenshtein"], ckpts["levenshtein_b"]], kernels, members=2,
        flags=NAT_MODELS["levenshtein"][1][:-1])  # an ensemble prints no step counts
    counts["nat_cmlm_reranker"], recs["cmlm_reranker"] = nat_serve_one(
        torch, fx, "cmlm_reranker", "cmlm", [ckpts["cmlm"], ckpts["ar"]], kernels,
        ["--iter-decode-with-external-reranker"])
    counts["nat_levenshtein_history"], recs["levenshtein_history"] = nat_serve_one(
        torch, fx, "levenshtein_history", "levenshtein", [ckpts["levenshtein"]], kernels,
        ["--retain-iter-history"])
    # the autoregressive transformer on the same batches
    for beam in (4, 1):
        _, stats = family_generate(fx, Path(ckpts["ar"]), fx["root"] / f"nat_ar_beam{beam}",
                                   "test", ["--batch-size", str(FAMILY_BATCH), "--dtype",
                                            "bfloat16", "--beam", str(beam)])
        recs[f"transformer_beam{beam}"] = {"sentences_per_s": stats["sentences"]
                                           / stats["decode_s"], "decode_s": stats["decode_s"]}
    log("nat_serve: sentences/s " + ", ".join(
        f"{k} {v['sentences_per_s']:.1f}" for k, v in recs.items()))
    for path in ckpts.values():
        Path(path).unlink()
    print(json.dumps({"nat_serve": recs}), flush=True)
    return counts


NAT_TRAIN_UPDATES = (10, 12)  # run A to 10 with a save there, run B resumed to 12
NAT_ONE_UPDATE = {  # name -> (task, --noise, criterion, model config)
    "cmlm": ("translation_lev", "random_mask", "nat_loss", {"arch": "cmlm_transformer_wmt_en_de"}),
    "nat": ("translation_lev", "full_mask", "nat_loss",
            {"arch": "nonautoregressive_transformer_wmt_en_de"}),
    "nacrf": ("translation_lev", "full_mask", "nacrf_loss", {"arch": "nacrf_transformer"}),
    "insertion": ("translation_ins", "levenshtein", "insertion_loss",
                  {"arch": "insertion_transformer"}),
}


def nat_train_argv(data: Path, save_dir: Path, max_update: int, task="translation_lev",
                   noise="levenshtein", criterion="levenshtein_loss",
                   model_cfg=None, extra=()):
    """fairseq's Levenshtein recipe (examples/nonautoregressive_translation):
    label smoothing 0.1, Adam (0.9, 0.98), inverse_sqrt lr 5e-4, dropout
    0.3, --max-tokens 8000; bf16, the warm-up cut to 4 updates."""
    return [str(data), "--task", task, "-s", "en", "-t", "de", "--noise", noise,
            *model_flags(model_cfg or {"arch": "levenshtein_transformer_wmt_en_de"}),
            "--criterion", criterion, "--label-smoothing", "0.1", "--dropout", "0.3",
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-4",
            "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4", "--max-tokens", "8000",
            "--dtype", "bfloat16", "--max-update", str(max_update), "--save-dir", str(save_dir),
            *extra]


def nat_data_s(task_name: str, noise: str, data: Path) -> dict:
    """The host seconds an epoch's batches spend in their collate, with and
    without the NAT noising (the edit operations and the noise), a batch."""
    from chimera_st_tpu_torch.tasks import setup_task

    out = {}
    for name, cfg in (("translation", {}), (task_name, {"noise": noise})):
        task = setup_task({"_name": name, "data": str(data), "source_lang": "en",
                           "target_lang": "de", **cfg})
        task.load_dataset("train")
        itr = task.make_batch_iterator(task.dataset("train"), max_tokens=8000, buffer_size=0)
        t0 = time.perf_counter()
        n = sum(1 for _ in itr.next_epoch_itr(shuffle=False))
        out[name] = (time.perf_counter() - t0) / n
    out["noising_s_a_batch"] = out[task_name] - out["translation"]
    return out


def phase_nat_train(torch, fx, data: Path, kernels):
    """``cli.train --task translation_lev --noise levenshtein --criterion
    levenshtein_loss --arch levenshtein_transformer_wmt_en_de`` at full
    width, bf16, on family_train's seeded pairs: run A to 10 updates (a save
    there), run B resumed to 12 under --profile, cli.generate of its
    checkpoint; then one update each of CMLM, vanilla NAT, NAT-CRF and
    insertion; fp32 card-vs-CPU parity of one update of each criterion
    (compare_step). Launches exact: K1 6 + 18 a Levenshtein micro-batch
    (the encoder and three decoder passes; attention dropout 0: kernel
    forward, plain backward), 6 + 6 the others'. Returns {run: launches};
    prints {"nat_train": {...}}."""
    import itertools
    import shutil

    from chimera_st_tpu_torch.checkpoint.store import read_state
    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "translation_lev", "data": str(data), "source_lang": "en",
                       "target_lang": "de", "noise": "levenshtein"})
    task.load_dataset("train")
    per_epoch = len(task.make_batch_iterator(task.dataset("train"), max_tokens=8000))
    tgt_tokens = int(task.dataset("train").tgt_sizes.sum())
    save_dir, trace_dir = fx["root"] / "nat_train", fx["root"] / "nat_train_trace"
    log(f"nat_train: cli.train --task translation_lev --arch levenshtein_transformer_wmt_en_de, "
        f"bf16, {per_epoch} micro-batches of at most 8000 tokens an epoch")
    counts, runs = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for label, max_update in zip("AB", NAT_TRAIN_UPDATES):
        for fn in kernels:
            fn.launches = 0
        extra = ["--disable-validation", "--save-interval-updates", str(NAT_TRAIN_UPDATES[0])]
        if label == "B":
            extra += ["--profile", str(trace_dir)]
        t0 = time.perf_counter()
        out = train.main(nat_train_argv(data, save_dir, max_update, extra=extra))
        torch.cuda.synchronize()
        counts[label] = {fn.__name__: fn.launches for fn in kernels}
        t = out["times"]
        updates = out["trainer"].num_updates - t["restored"]["step"]
        implied = {"encoder_attention": 24 * updates, "conv_tail": 0, "decode_attention": 0,
                   "logmel": 0}
        log(f"  run {label}: {time.perf_counter() - t0:.1f} s, step {t['restored']['step']} -> "
            f"{out['trainer'].num_updates}; saves {[round(s, 2) for s in t['save_s']]} s, load "
            f"{t['load_s']:.2f} s; launches {counts[label]}")
        if counts[label] != implied or updates != max_update - t["restored"]["step"]:
            raise AssertionError(f"nat_train run {label}: launches {counts[label]} (want "
                                 f"{implied}), {updates} updates")
        runs[label] = t
        del out
    a, b = runs["A"], runs["B"]
    last = save_dir / "checkpoint_last.ckpt"
    payload = read_state(str(last))
    if b["restored"]["step"] != NAT_TRAIN_UPDATES[0] or payload["step"] != NAT_TRAIN_UPDATES[1]:
        raise AssertionError(f"nat_train: B restored at {b['restored']['step']}, saved step "
                             f"{payload['step']}")
    del payload
    after_first = a["update_s"][1:]
    rate = len(after_first) / sum(after_first)
    rec = dict(updates_per_s_after_first=rate, target_tokens_per_s=tgt_tokens / per_epoch * rate,
               update_s={"A": a["update_s"], "B": b["update_s"]},
               save_s=a["save_s"] + b["save_s"], resume_load_s=b["load_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               profile_run_b=trace_busy(trace_dir / "trace.json"),
               data_s=nat_data_s("translation_lev", "levenshtein", data))
    log(f"  run A: {rate:.3f} updates/s after the first, {rec['target_tokens_per_s']:.0f} target "
        f"tokens/s; peak {rec['peak_memory_gb']:.2f} GB; run B busy "
        f"{100 * rec['profile_run_b']['busy_share']:.1f} %; data_s {rec['data_s']}")
    # cli.generate of the trained checkpoint
    for fn in kernels:
        fn.launches = 0
    with counted_refinement() as rounds:
        text, _ = nat_generate(fx, "translation_lev", str(last), fx["root"] / "nat_train_decode",
                               "valid", ["--batch-size", str(FAMILY_PARITY_PAIRS),
                                         "--dtype", "bfloat16", "--iter-decode-max-iter", "9"])
        torch.cuda.synchronize()
    gcounts = {fn.__name__: fn.launches for fn in kernels}
    if (len(nat_lines(text, "H")) != FAMILY_PARITY_PAIRS
            or gcounts["encoder_attention"] != nat_expected_k1("levenshtein", 1, rounds)):
        raise AssertionError(f"nat_train generate: launches {gcounts}, rounds {rounds}")
    rec["generate"] = {"rounds": rounds, "launches": gcounts}
    counts["generate"] = gcounts
    # one update each of the other models
    for name, (task_name, noise, criterion, cfg) in NAT_ONE_UPDATE.items():
        for fn in kernels:
            fn.launches = 0
        out = train.main(nat_train_argv(data, fx["root"] / f"nat_train_{name}", 1, task_name,
                                        noise, criterion, cfg, ["--disable-validation",
                                                                "--no-save"]))
        torch.cuda.synchronize()
        counts[name] = {fn.__name__: fn.launches for fn in kernels}
        if counts[name]["encoder_attention"] != 12 or out["trainer"].num_updates != 1:
            raise AssertionError(f"nat_train {name}: launches {counts[name]}")
        rec[f"{name}_update_s"] = out["times"]["update_s"]
        log(f"  {name}: one update ({criterion}) in {out['times']['update_s'][0]:.2f} s; "
            f"launches {counts[name]}")
        del out
    # fp32 card vs CPU, one update of each criterion
    rec["parity"] = {}
    for name, (task_name, noise, criterion, cfg) in [
            ("levenshtein", ("translation_lev", "levenshtein", "levenshtein_loss",
                             {"arch": "levenshtein_transformer_wmt_en_de"})),
            *NAT_ONE_UPDATE.items()]:
        ptask = setup_task({"_name": task_name, "data": str(data), "source_lang": "en",
                            "target_lang": "de", "noise": noise})
        ptask.load_dataset("train")
        micro = list(itertools.islice(ptask.make_batch_iterator(
            ptask.dataset("train"), max_sentences=4).next_epoch_itr(shuffle=False), 2))
        keys = ("loss",) if criterion in ("nacrf_loss", "insertion_loss") else ("loss",
                                                                                "nll_loss")
        rec["parity"][name] = family_step_parity(
            torch, f"nat_train {name}", ptask, cfg, {"_name": criterion, "label_smoothing": 0.1},
            micro, keys=keys)
    for d in (save_dir, trace_dir, fx["root"] / "nat_train_decode"):
        shutil.rmtree(d)
    print(json.dumps({"nat_train": rec}), flush=True)
    return {f"nat_train_{k}": v for k, v in counts.items()}


def phase_nat_shapes(torch, ops, serve_seen, train_seen, records):
    """K1 at the shapes of nat_serve's bf16 batches of 32 (the canvas of 64
    and CMLM's 160 candidates, the encoder) timed: time, bound, share, SDPA;
    every other shape nat_serve and nat_train launched (the parity batches,
    the training micro-batches, K3 of the autoregressive comparison) for
    accuracy in bf16 and fp32; the training targets' largest micro-batch
    and levenshtein_transformer_vaswani_wmt_en_de_big's width (16 heads of
    64) on the canvas timed too."""
    served = {name: [p for p in pairs if name == "encoder_attention" and p[0][0] >= FAMILY_BATCH]
              for name, pairs in serve_seen.items()}
    rest = {name: [p for p in serve_seen[name] + train_seen[name] if p not in served[name]]
            for name in serve_seen}
    phase_shapes(torch, ops, served, records, "nat_serve", lambda sh: (
        {(32, 64, 8, 64), (160, 64, 8, 64)} <= set(sh["encoder_attention"])),
        timed=("encoder_attention",))
    phase_shapes(torch, ops, rest, records, "nat", lambda sh: (
        {(H, D) for _, _, H, D in sh["encoder_attention"]} == {(8, 64)}
        and not sh["conv_tail"] and {C for *_, C in sh["decode_attention"]} == {1, 4}))
    rec = {r["name"]: r for r in records}["encoder_attention"]
    B, T, H, D = max((shape for shape, _ in train_seen["encoder_attention"]),
                     key=lambda sh: sh[0] * sh[1])
    tensor = Inputs(torch, 4)
    rec["shapes"][f"nat_train_B{B}_T{T}_H{H}_D{D}"] = k1_case(torch, ops[0], tensor, "nat_train",
                                                             B, T, H, D)
    rec["shapes"]["nat_big_B32_T64_H16_D64"] = k1_case(torch, ops[0], tensor, "nat_big", 32, 64,
                                                       16, 64)


# ---- BART / mBART and multilingual translation: bart_serve (this slice's
# main path), bart_train, bart_shapes

MBART_LANGS = ("ar_AR,cs_CZ,de_DE,en_XX,es_XX,et_EE,fi_FI,fr_XX,gu_IN,hi_IN,it_IT,ja_XX,kk_KZ,"
               "ko_KR,lt_LT,lv_LV,my_MM,ne_NP,nl_XX,ro_RO,ru_RU,si_LK,tr_TR,vi_VN,zh_CN")
MBART_VOCAB = 250_027  # mBART.cc25's table: the dictionary, 25 [lang] tags and <mask>
BART_VOCAB = 50_265  # bart.large's (GPT-2 BPE) dictionary
IWSLT_VOCAB = 10_000  # a joined dictionary of the multilingual IWSLT example's size
MBART_TEST_PAIRS = 32
MBART_PARITY_PAIRS = 2
MBART_DECODE = ["--max-decode-len", "64"]  # cut from fairseq's --max-len-b 200
MBART_CKPT = {"arch": "mbart_large", "dropout": 0.3, "attention_dropout": 0.1}
BART_CKPT = {"arch": "bart_large"}
# the parity checkpoint of each trained model: the widths and the vocabulary
# kept, the BART models' depth cut to 2 + 2 (an fp32 CPU step at full depth
# would not finish in the script's time)
BART_PARITY_DEPTH = {"encoder_layers": 2, "decoder_layers": 2}


def seeded_words(n_words: int, seed: int, path: Path):
    """A dictionary file of ``n_words`` subwords (Zipf 1.1 counts), "." the
    third; -> (the words, their probabilities)."""
    rng = np.random.default_rng(seed)
    words = np.asarray([f"s{i}" for i in range(n_words)])
    words[2] = "."
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    p /= p.sum()
    counts = np.maximum((p * 1e8).astype(np.int64), 1)
    path.write_text("".join(f"{w} {c}\n" for w, c in zip(words, counts)))
    return words, p


def text_pairs(rng, words, p, n, lengths=MT_LENGTHS):
    """n source lines of Zipf words and targets within +-20 % of their length."""
    src, _ = zipf_rows(rng, words, p, n, lengths)
    tgt = [" ".join(words[rng.choice(len(words), size=max(1, int(round(
        len(line.split()) * rng.uniform(0.8, 1.2)))), p=p)]) for line in src]
    return src, tgt


def write_pairs(raw: Path, prefix: str, s: str, t: str, pairs) -> str:
    src, tgt = pairs
    (raw / f"{prefix}.{s}").write_text("\n".join(src) + "\n")
    (raw / f"{prefix}.{t}").write_text("\n".join(tgt) + "\n")
    return str(raw / prefix)


def make_bart_fixture(root: Path, seed: int = 83) -> dict:
    """Seeded text for the BART phases, binarized by the port's preprocess
    CLI: ``mbart`` (en_XX -> ro_RO over a dictionary that makes mBART.cc25's
    250,027-row table with the task's tags: 200 train, the parity pairs as
    ``valid``, 32 test), ``bart_mt`` (en -> de, 32 test pairs, bart.large's
    50,265 rows), ``mono`` (a denoising stream of sentences ending in ".",
    40,000 subwords, on bart's dictionary), ``glue`` (RTE-like premise /
    hypothesis pairs, 64 train and 16 valid, text labels) and ``iwslt``
    (de-en and fr-en, 2,400 train and 8 valid pairs each of 4-40 subwords,
    one joined 10,000-subword dictionary, also as ``dict.txt``)."""
    import shutil

    from chimera_st_tpu_torch.cli import preprocess

    rng = np.random.default_rng(seed)
    raw = root / "raw"
    raw.mkdir(parents=True)
    t0 = time.perf_counter()
    n_tags = len(MBART_LANGS.split(",")) + 1
    m_words, m_p = seeded_words(MBART_VOCAB - 4 - n_tags, seed, root / "dict.mbart.txt")
    b_words, b_p = seeded_words(BART_VOCAB - 4, seed + 1, root / "dict.bart.txt")
    i_words, i_p = seeded_words(IWSLT_VOCAB - 4, seed + 2, root / "dict.iwslt.txt")
    splits = {split: write_pairs(raw, f"m{split}", "en_XX", "ro_RO",
                                 text_pairs(rng, m_words, m_p, n, (4, 60) if split == "train"
                                            else MT_LENGTHS))
              for split, n in (("train", 200), ("valid", MBART_PARITY_PAIRS),
                               ("test", MBART_TEST_PAIRS))}
    preprocess.main(["-s", "en_XX", "-t", "ro_RO", "--joined-dictionary", "--srcdict",
                     str(root / "dict.mbart.txt"), "--trainpref", splits["train"],
                     "--validpref", splits["valid"], "--testpref", splits["test"],
                     "--destdir", str(root / "mbart")])
    test = write_pairs(raw, "btest", "en", "de", text_pairs(rng, b_words, b_p, MBART_TEST_PAIRS))
    preprocess.main(["-s", "en", "-t", "de", "--joined-dictionary", "--srcdict",
                     str(root / "dict.bart.txt"), "--testpref", test,
                     "--destdir", str(root / "bart_mt")])
    for split, n_tokens in (("train", 40_000), ("valid", 2_000)):
        lines, n = [], 0
        while n < n_tokens:
            sents = [zipf_rows(rng, b_words, b_p, 1, (4, 30))[0][0] + " ."
                     for _ in range(int(rng.integers(2, 6)))]
            lines.append(" ".join(sents))
            n += sum(len(s.split()) for s in sents)
        (raw / f"mono.{split}").write_text("\n".join(lines) + "\n")
    preprocess.main(["--only-source", "--srcdict", str(root / "dict.bart.txt"), "--trainpref",
                     str(raw / "mono.train"), "--validpref", str(raw / "mono.valid"),
                     "--destdir", str(root / "mono")])
    shutil.copy(root / "mono" / "dict.None.txt" if (root / "mono" / "dict.None.txt").exists()
                else root / "dict.bart.txt", root / "mono" / "dict.txt")
    for k, (n, lengths) in enumerate(((64, (20, 100)), (64, (4, 20)))):
        pre = {}
        for split, m in (("train", n), ("valid", 16)):
            rows, _ = zipf_rows(rng, b_words, b_p, m, lengths)
            (raw / f"glue{k}.{split}").write_text("\n".join(rows) + "\n")
            pre[split] = str(raw / f"glue{k}.{split}")
        preprocess.main(["--only-source", "--srcdict", str(root / "dict.bart.txt"),
                         "--trainpref", pre["train"], "--validpref", pre["valid"],
                         "--destdir", str(root / "glue" / f"input{k}")])
        shutil.copy(root / "dict.bart.txt", root / "glue" / f"input{k}" / "dict.txt")
    (root / "glue" / "label").mkdir()
    for split, m in (("train", 64), ("valid", 16)):
        labels = rng.choice(["entailment", "not_entailment"], m)
        (root / "glue" / "label" / f"{split}.label").write_text("\n".join(labels) + "\n")
    for pair in ("de-en", "fr-en"):
        s, t = pair.split("-")
        pre = {split: write_pairs(raw, f"{pair}.{split}", s, t,
                                  text_pairs(rng, i_words, i_p, n, (4, 40)))
               for split, n in (("train", 2400), ("valid", 8))}
        preprocess.main(["-s", s, "-t", t, "--joined-dictionary", "--srcdict",
                         str(root / "dict.iwslt.txt"), "--trainpref", pre["train"],
                         "--validpref", pre["valid"], "--destdir", str(root / "iwslt")])
    shutil.copy(root / "dict.iwslt.txt", root / "iwslt" / "dict.txt")
    log(f"bart fixture: mBART {MBART_VOCAB}-row table, bart {BART_VOCAB}, iwslt {IWSLT_VOCAB}; "
        f"binarized in {time.perf_counter() - t0:.1f} s")
    return dict(root=root, mbart=root / "mbart", bart_mt=root / "bart_mt", mono=root / "mono",
                glue=root / "glue", iwslt=root / "iwslt")


def bart_task_args(fx, name: str):
    """The task flags of one BART phase's data."""
    return {
        "mbart": [str(fx["mbart"]), "--task", "translation_from_pretrained_bart", "-s", "en_XX",
                  "-t", "ro_RO", "--langs", MBART_LANGS],
        "bart_mt": [str(fx["bart_mt"]), "--task", "translation", "-s", "en", "-t", "de"],
        "iwslt_mse": [str(fx["iwslt"]), "--task", "translation_multi_simple_epoch",
                      "--lang-pairs", "de-en,fr-en", "--encoder-langtok", "src",
                      "--decoder-langtok"],
    }[name]


def bart_checkpoint(torch, fx, name: str, data: str, model_cfg: dict, seed: int) -> Path:
    """A native checkpoint (the JAX layout, through the port's writer) of
    ``model_cfg`` on the task of ``data`` with seeded random weights."""
    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.models.interlingua import init_params_

    task = bart_run_task(bart_task_args(fx, data))
    t0 = time.perf_counter()
    model = init_params_(task.build_model(dict(model_cfg), device="cuda", train=True),
                         torch.Generator(device="cuda").manual_seed(seed))
    path = fx["root"] / f"{name}.ckpt"
    save_model(str(path), model, model_cfg)
    n = sum(p.numel() for p in model.parameters())
    log(f"  {name}: {model_cfg['arch']}, {n / 1e6:.1f} M parameters (two {len(task.src_dict)}-row "
        f"tables: share_all_embeddings is not honoured); {path.stat().st_size / 1e9:.2f} GB "
        f"written in {time.perf_counter() - t0:.1f} s")
    return path


def bart_generate(fx, data: str, ckpt: Path, out_dir: Path, subset: str, extra):
    """cli.generate on one BART phase's data -> (output text, its returned
    counts and times)."""
    from chimera_st_tpu_torch.cli import generate

    out_dir.mkdir(parents=True, exist_ok=True)
    stats = generate.main([*bart_task_args(fx, data), "--path", str(ckpt), "--gen-subset",
                           subset, *MBART_DECODE, "--scoring", "bleu", "--results-path",
                           str(out_dir), *extra])
    return (out_dir / f"generate-{subset}.txt").read_text(), stats


def bart_serve_one(torch, fx, label, data, ckpt: Path, kernels, beam: int, layers: int,
                   parity: bool):
    """One model through cli.generate: with ``parity`` fp32 on the card
    against --device cpu on the ``valid`` split (MBART_PARITY_PAIRS), best
    hypotheses identical and equal decoder steps; then bf16 on the 32
    ``test`` pairs in one batch with the counts zeroed before and read
    after: K1 ``layers`` a batch, K3 ``layers`` a decoder step."""
    work = fx["root"] / label
    rec = {}
    if parity:
        common = ["--batch-size", str(MBART_PARITY_PAIRS), "--dtype", "float32", "--beam",
                  str(beam), *PARITY_DECODE]
        texts, steps_of = {}, {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            t0 = time.perf_counter()
            with counted_decoder_steps() as steps:
                texts[side], _ = bart_generate(fx, data, ckpt, work / f"parity_{side}",
                                               "valid", common + ["--device", dev])
            steps_of[side] = steps[0]
            rec[f"fp32_{side}_s"] = time.perf_counter() - t0
        (gh, gfull, _), (ch, cfull, _) = (parse_protocol(texts[d]) for d in ("card", "cpu"))
        if len(gfull) != MBART_PARITY_PAIRS or len(cfull) != MBART_PARITY_PAIRS \
                or steps_of["card"] != steps_of["cpu"]:
            raise AssertionError(f"{label}: samples card {len(gfull)} / CPU {len(cfull)}, "
                                 f"decoder steps {steps_of}")
        same_hypotheses(f"{label} fp32 card vs CPU", gh, ch, MBART_PARITY_PAIRS)
        rec["fp32_decoder_steps"] = steps_of["card"]
        log(f"  {label} fp32: card {rec['fp32_card_s']:.1f} s, CPU {rec['fp32_cpu_s']:.1f} s, "
            f"{steps_of['cpu']} decoder steps each")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_decoder_steps() as steps:
        t0 = time.perf_counter()
        text, stats = bart_generate(fx, data, ckpt, work / "serve", "test",
                                    ["--batch-size", str(MBART_TEST_PAIRS), "--dtype",
                                     "bfloat16", "--beam", str(beam)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    hyps, full, last = parse_protocol(text)
    implied = {"encoder_attention": layers, "conv_tail": 0,
               "decode_attention": layers * steps[0], "logmel": 0}
    rec.update(sentences=stats["sentences"], wall_s=wall, decode_s=stats["decode_s"],
               load_s=stats["load_s"], sentences_per_s=stats["sentences"] / stats["decode_s"],
               decoder_steps=steps[0], peak_memory_gb=peak / 1e9, launches=counts)
    log(f"  {label} bf16 beam {beam}: {stats['sentences']} sentences in {wall:.1f} s (decode "
        f"{stats['decode_s']:.2f} s, {rec['sentences_per_s']:.1f} sentences/s; load "
        f"{stats['load_s']:.2f} s), {steps[0]} decoder steps; peak {peak / 1e9:.2f} GB; "
        f"launches {counts}; {last}")
    if (counts != implied or steps[1] != layers * steps[0] or not steps[0]
            or len(full) != MBART_TEST_PAIRS
            or any(not np.isfinite(h[0][0]) for h in hyps.values())):
        raise AssertionError(f"{label}: launches {counts} (want {implied}), {len(full)} samples")
    return counts, rec


def phase_bart_serve(torch, fx, kernels):
    """The slice's main path: ``mbart_large`` at full width and depth (12 +
    12 layers of 1,024, 16 heads of 64, FFN 4,096, mBART.cc25's 250,027-row
    table) served by ``cli.generate --task translation_from_pretrained_bart
    -s en_XX -t ro_RO --langs <the 25 cc25 languages>`` at fairseq's
    README operating point (batch 32, beam 5): fp32 card vs CPU on the
    valid pairs, then bf16 on 32 test pairs; beside it ``bart_large`` under
    ``--task translation`` at beam 4. Returns ({run: launches}, the mBART
    checkpoint); prints {"bart_serve": {...}}."""
    log(f"bart_serve: cli.generate {' '.join(MBART_DECODE)}, batches of {MBART_TEST_PAIRS}")
    mbart = bart_checkpoint(torch, fx, "mbart_large", "mbart", MBART_CKPT, 91)
    counts, recs = {}, {}
    counts["bart_serve"], recs["mbart_large"] = bart_serve_one(
        torch, fx, "bart_serve", "mbart", mbart, kernels, 5, 12, parity=True)
    bart_large = bart_checkpoint(torch, fx, "bart_large", "bart_mt", BART_CKPT, 92)
    counts["bart_serve_bart_large"], recs["bart_large"] = bart_serve_one(
        torch, fx, "bart_serve_bart_large", "bart_mt", bart_large, kernels, 4, 12, parity=False)
    bart_large.unlink()
    print(json.dumps({"bart_serve": recs}), flush=True)
    return counts, mbart


@contextlib.contextmanager
def counted_microbatches():
    """While open, counts the training micro-batches the train step runs."""
    from chimera_st_tpu_torch.train import train_step

    n = [0]
    real = train_step.microbatch_grad

    def counted(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    train_step.microbatch_grad = counted
    try:
        yield n
    finally:
        train_step.microbatch_grad = real


def bart_train_runs(fx, mbart_ckpt: Path):
    """name -> the run: its data flags, model config, criterion, --max-tokens
    and other recipe flags (fairseq's README flags that the train CLI
    parses, each run cut to a few updates), the encoder's layers, whether
    K1 runs in training (attention dropout 0) and the validation batch
    size."""
    common = ["--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--dtype", "bfloat16",
              "--log-interval", "1"]
    return {
        # examples/mbart/README.md's fine-tune, from the served checkpoint as
        # the pretrained model (--restore-file and the four --reset-* flags)
        "mbart_ft": dict(
            data=bart_task_args(fx, "mbart"),
            model={"arch": "mbart_large", "layernorm_embedding": True},
            criterion="label_smoothed_cross_entropy", layers=12, k1_train=False, valid_bs=8,
            max_tokens=1024,
            recipe=[*common, "--label-smoothing", "0.2", "--adam-eps", "1e-06",
                    "--lr-scheduler", "polynomial_decay", "--lr", "3e-05", "--warmup-updates",
                    "2", "--total-num-update", "40000", "--dropout", "0.3",
                    "--attention-dropout", "0.1", "--weight-decay", "0.0", "--update-freq", "2", "--seed", "222", "--max-update", "4",
                    "--no-save", "--restore-file", str(mbart_ckpt), "--reset-optimizer",
                    "--reset-meters", "--reset-dataloader", "--reset-lr-scheduler"]),
        # the BART paper's noise: text infilling and sentence permutation
        "denoising": dict(
            data=[str(fx["mono"]), "--task", "denoising", "--mask", "0.3", "--mask-random",
                  "0.1", "--poisson-lambda", "3.5", "--permute-sentences", "1",
                  "--replace-length", "1", "--tokens-per-sample", "512"],
            model={"arch": "bart_base"}, criterion="label_smoothed_cross_entropy", layers=6,
            k1_train=True, valid_bs=8, max_tokens=4096,
            recipe=[*common, "--label-smoothing", "0.1", "--lr", "4e-4", "--lr-scheduler",
                    "polynomial_decay", "--warmup-updates", "2", "--total-num-update",
                    "500000", "--max-update", "3"]),
        # examples/bart/README.glue.md, RTE
        "sentence_prediction": dict(
            data=[str(fx["glue"]), "--task", "sentence_prediction", "--num-classes", "2",
                  "--max-positions", "1024"],
            model={"arch": "bart_large"}, criterion="sentence_prediction", layers=12,
            k1_train=False, valid_bs=16, max_tokens=None,
            recipe=[*common, "--batch-size", "16", "--dropout", "0.1", "--attention-dropout",
                    "0.1", "--weight-decay", "0.01", "--adam-eps", "1e-08", "--clip-norm",
                    "0.0", "--lr-scheduler", "polynomial_decay", "--lr", "1e-05",
                    "--total-num-update", "2036", "--warmup-updates", "2", "--max-update", "4",
                    "--no-save"]),
        # examples/translation/README.md, multilingual_transformer_iwslt_de_en
        "multilingual": dict(
            data=[str(fx["iwslt"]), "--task", "multilingual_translation", "--lang-pairs",
                  "de-en,fr-en"],
            model={"arch": "multilingual_transformer_iwslt_de_en", "share_decoders": True,
                   "share_decoder_input_output_embed": True},
            criterion="multilingual_label_smoothed_cross_entropy", layers=6, k1_train=True,
            valid_bs=8, max_tokens=4000,
            recipe=[*common, "--lr", "0.0005", "--lr-scheduler", "inverse_sqrt",
                    "--warmup-updates", "4", "--warmup-init-lr", "1e-07", "--label-smoothing",
                    "0.1", "--dropout", "0.3", "--weight-decay", "0.0001", "--update-freq",
                    "8", "--max-update", "3", "--no-save"]),
        # examples/multilingual/README.md, on a transformer
        "multi_simple_epoch": dict(
            data=[*bart_task_args(fx, "iwslt_mse"), "--sampling-temperature", "1.5"],
            model={"arch": "transformer"}, criterion="label_smoothed_cross_entropy", layers=6,
            k1_train=False, valid_bs=8, max_tokens=1024,
            recipe=[*common, "--label-smoothing", "0.2", "--adam-eps", "1e-06",
                    "--lr-scheduler", "inverse_sqrt", "--lr", "3e-05", "--warmup-updates",
                    "2", "--dropout", "0.3", "--attention-dropout", "0.1", "--weight-decay",
                    "0.0", "--update-freq", "2", "--max-update", "3"]),
    }


def max_tokens_flag(run):
    return [] if run["max_tokens"] is None else ["--max-tokens", str(run["max_tokens"])]


def bart_run_task(data_flags):
    """The task of a run's data flags, as the CLIs build it."""
    from chimera_st_tpu_torch.cli import options
    from chimera_st_tpu_torch.tasks import setup_task

    args, extra = options.parse_with_model_overrides(options.base_parser("bart"), data_flags)
    return setup_task({"_name": args.task, "data": args.data, "source_lang": args.source_lang,
                       "target_lang": args.target_lang, **extra})


def bart_train_one(torch, name, run, label, save_dir: Path, n_valid: int, kernels, extra=()):
    """One cli.train run with the counts zeroed before and read after; K1
    exact. -> (launches, record)."""
    from chimera_st_tpu_torch.cli import train

    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_microbatches() as micro, counted_decoder_steps() as steps:
        out = train.main([*run["data"], *model_flags(run["model"]), "--criterion",
                          run["criterion"], *run["recipe"], *max_tokens_flag(run),
                          "--batch-size-valid", str(run["valid_bs"]), "--save-dir",
                          str(save_dir), *extra])
    torch.cuda.synchronize()
    c = {fn.__name__: fn.launches for fn in kernels}
    t = out["times"]
    updates = out["trainer"].num_updates - t["restored"]["step"]
    implied = {"encoder_attention": run["layers"] * (micro[0] * run["k1_train"]
                                                     + n_valid * len(t["valid_s"])),
               "conv_tail": 0, "decode_attention": 0, "logmel": 0}
    timed = t["update_s"][1:]  # after the first update of the run
    r = dict(updates=updates, micro_batches=micro[0],
             updates_per_s_after_first=len(timed) / sum(timed), update_s=t["update_s"],
             valid_s=t["valid_s"], valid=t["valid"], save_s=t["save_s"], load_s=t["load_s"],
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=c,
             wall_s=time.perf_counter() - t0,
             params_m=sum(p.numel() for p in out["trainer"].model.parameters()) / 1e6)
    log(f"  bart_train {name} run {label}: {r['wall_s']:.1f} s, {r['params_m']:.1f} M "
        f"parameters, step {t['restored']['step']} -> {out['trainer'].num_updates} ({micro[0]} "
        f"micro-batches), {r['updates_per_s_after_first']:.3f} updates/s after the first, peak "
        f"{r['peak_memory_gb']:.2f} GB, load {t['load_s']:.2f} s, saves "
        f"{[round(s, 2) for s in t['save_s']]} s, validation {t['valid']}; launches {c}")
    if (c != implied or not updates or steps[0] or not t["valid_s"]
            or any(not np.isfinite(v) for v in t["valid"])):
        raise AssertionError(f"bart_train {name} run {label}: launches {c} (want {implied}), "
                             f"{updates} updates, decoder steps {steps[0]}")
    return c, r, t["restored"]["step"]


def phase_bart_train(torch, fx, mbart_ckpt: Path, kernels):
    """The five training runs of the slice through cli.train, bf16, each
    to a few updates with a validation at the stop: the mBART fine-tune
    from the served checkpoint, BART denoising (run A to 3 updates, run B
    resumed to 5), RTE on bart_large, the multilingual transformer (de-en
    and fr-en, --share-decoders, --update-freq 8) and
    translation_multi_simple_epoch on a transformer (then cli.generate of
    its checkpoint on the valid pairs); then one fp32 update of each, card
    vs CPU (family_step_parity; the BART models at BART_PARITY_DEPTH).
    Launches exact: K1 the encoder's layers a training micro-batch where
    attention dropout is 0 (denoising, multilingual), none where it is 0.1,
    and the encoder's layers a validation batch; K3 none in training.
    Returns {run: launches}; prints {"bart_train": {...}}."""
    import itertools
    import shutil

    counts, rec = {}, {}
    for name, run in bart_train_runs(fx, mbart_ckpt).items():
        task = bart_run_task(run["data"])
        task.load_dataset("valid")
        n_valid = len(task.make_batch_iterator(task.dataset("valid"),
                                               max_tokens=run["max_tokens"],
                                               max_sentences=run["valid_bs"]))
        save_dir = fx["root"] / f"bart_train_{name}"
        counts[f"bart_train_{name}"], rec[name], _ = bart_train_one(
            torch, name, run, "A", save_dir, n_valid, kernels)
        if name == "denoising":
            counts["bart_train_denoising_resume"], rec["denoising_resume"], step = \
                bart_train_one(torch, name, run, "B", save_dir, n_valid, kernels,
                               ["--max-update", "5"])
            if step != 3:
                raise AssertionError(f"bart_train denoising: run B restored at {step}")
        if name == "multi_simple_epoch":
            for fn in kernels:
                fn.launches = 0
            with counted_decoder_steps() as steps:
                text, _ = bart_generate(fx, "iwslt_mse", save_dir / "checkpoint_last.ckpt",
                                        save_dir / "decode", "valid",
                                        ["--batch-size", "16", "--dtype", "bfloat16"])
                torch.cuda.synchronize()
            c = {fn.__name__: fn.launches for fn in kernels}
            _, full, line = parse_protocol(text)
            if len(full) != 16 or c["encoder_attention"] != 6 \
                    or c["decode_attention"] != 6 * steps[0]:
                raise AssertionError(f"multi_simple_epoch generate: {len(full)} samples, {c}")
            counts["bart_train_multi_simple_epoch_decode"] = c
            log(f"  multi_simple_epoch cli.generate: 16 sentences, {steps[0]} decoder steps, "
                f"launches {c}; {line}")
        task.load_dataset("train")
        micro = list(itertools.islice(task.make_batch_iterator(
            task.dataset("train"), max_sentences=2).next_epoch_itr(shuffle=False), 2))
        model_cfg = dict(run["model"])
        if model_cfg["arch"].startswith(("bart", "mbart")):
            model_cfg.update(BART_PARITY_DEPTH)
        rec[f"{name}_parity"] = family_step_parity(
            torch, f"bart_train {name}", task, model_cfg,
            {"_name": run["criterion"], "label_smoothing": 0.1}, micro,
            keys=("loss",) if run["criterion"] == "sentence_prediction" else ("loss", "nll_loss"),
            prepare=zero_fixed_dropout)
        shutil.rmtree(save_dir, ignore_errors=True)
    print(json.dumps({"bart_train": rec}), flush=True)
    return counts


def zero_fixed_dropout(model) -> None:
    """The multilingual decoders' attention and activation dropout, 0.1
    whatever the config (as in the JAX package), set to 0 for a parity
    step (other models have every dropout 0 from their config)."""
    if hasattr(model, "decoders"):
        for m in model.decoders.modules():
            for attr in ("dropout", "activation_dropout"):
                if isinstance(getattr(m, attr, None), float):
                    setattr(m, attr, 0.0)


def phase_bart_shapes(torch, ops, seen, records):
    """K1 and K3 at every shape bart_serve and bart_train launched against
    the plain versions. Timed (K1 with SDPA beside it): the served batches
    (K1 at B 32, K3 at 32 sentences) and, for each head width, the
    largest training or validation batch; the others for accuracy (the
    training micro-batches of --max-tokens make dozens of shapes)."""
    k1 = seen["encoder_attention"]
    largest = {}
    for shape, dtype in k1:
        hd = shape[2:]
        if shape[0] != MBART_TEST_PAIRS and (hd not in largest or shape[0] * shape[1]
                                              > largest[hd][0][0] * largest[hd][0][1]):
            largest[hd] = (shape, dtype)
    timed_k1 = [p for p in k1 if p[0][0] == MBART_TEST_PAIRS] + list(largest.values())
    k3 = seen["decode_attention"]
    timed_k3 = [p for p in k3 if p[0][0] // p[0][4] == MBART_TEST_PAIRS]
    timed = {"encoder_attention": timed_k1, "conv_tail": [], "decode_attention": timed_k3}
    rest = {"encoder_attention": [p for p in k1 if p not in timed_k1], "conv_tail": [],
            "decode_attention": [p for p in k3 if p not in timed_k3]}
    phase_shapes(torch, ops, timed, records, "bart_serve", lambda sh: (
        {(16, 64), (12, 64), (4, 128), (8, 64)} <= {(H, D) for _, _, H, D
                                                    in sh["encoder_attention"]}
        and {(16, 5), (16, 4)} <= {(H, C) for _, H, _, _, C in sh["decode_attention"]}),
        timed=("encoder_attention", "decode_attention"))
    phase_shapes(torch, ops, rest, records, "bart", lambda sh: (
        (8, 5) in {(H, C) for _, H, _, _, C in sh["decode_attention"]}
        and not sh["conv_tail"]))


# ---- the wav2vec family: speech recognition (CTC and seq2seq) served and
# fine-tuned, self-supervised pre-training and Chimera's bimodal variant

# fairseq's dict.ltr.txt: the word boundary, 26 letters, the apostrophe
W2V_LETTERS = "| E T A O N I H S R D L U M W C F G Y P B V K ' X J Q Z".split()
ASR_WAVS = 24  # 2-16 s
ASR_PARITY_WAVS = 2  # the fp32 card-vs-CPU decodes and the served beam-50 run
ASR_MAX_TOKENS = "1280000"  # the README's fine-tune --max-tokens
ASR_BEAM = ["--beam", "50", "--ctc-lm-weight", "0.5"]
W2V_BASE = {"w2v2_embed_dim": 768, "w2v2_ffn_dim": 3072, "w2v2_layers": 12, "w2v2_heads": 12}
ASR_CTC = {"arch": "wav2vec_ctc", "apply_mask": True, **W2V_BASE}
ASR_S2S = {"arch": "wav2vec_seq2seq", **W2V_BASE}  # the decoder's defaults: 10 x 1,024, 16 heads
PRETRAIN_WAVS = 10  # 16-20 s: crops of 250,000 samples, 5 a batch at --max-tokens 1400000
PRETRAIN_T1 = (250000 - 10) // 5 + 1  # K2's input length at a crop of 250,000 samples
PRETRAIN_T = 781  # the trunk's frames of such a crop
PRETRAIN_FLAGS = ["--encoder-heads", "12", "--final-dim", "256", "--latent-vars", "320",
                  "--latent-groups", "2", "--num-negatives", "100", "--mask-prob", "0.65",
                  "--max-sample-size", "250000", "--min-sample-size", "32000",
                  "--loss-weights", "[0.1, 10]", "--optimizer", "adam", "--adam-betas",
                  "(0.9, 0.98)", "--lr", "0.0005", "--lr-scheduler", "polynomial_decay",
                  "--warmup-updates", "1", "--total-num-update", "400000",
                  "--max-tokens", "1400000", "--dtype", "bfloat16", "--log-interval", "1"]


def letter_line(rng) -> str:
    """A transcript in fairseq's letter format: ``H E L L O | W O R L D |``."""
    words = ["".join(rng.choice(W2V_LETTERS[1:], size=int(rng.integers(1, 8))))
             for _ in range(int(rng.integers(2, 12)))]
    return " ".join(" ".join(w) + " |" for w in words)


def write_manifest(root: Path, split: str, rows, labels=None) -> None:
    cols = "audio\tn_frames" + ("\taudio2\tn_frames2" if len(rows[0]) > 2 else "")
    (root / f"{split}.tsv").write_text(
        cols + "\n" + "".join("\t".join(map(str, r)) + "\n" for r in rows))
    if labels is not None:
        (root / f"{split}.ltr").write_text("".join(line + "\n" for line in labels))


def seeded_letter_arpa(path: Path, seed: int) -> Path:
    """A back-off 3-gram LM in ARPA text over the letters (log10 scores):
    every unigram, seeded bigrams and trigrams."""
    rng = np.random.default_rng(seed)
    grams = [[(w,) for w in W2V_LETTERS + ["<unk>"]]]
    for n in (2, 3):
        grams.append(sorted({tuple(rng.choice(W2V_LETTERS, size=n)) for _ in range(300)}))
    lines = ["\\data\\"] + [f"ngram {n + 1}={len(g)}" for n, g in enumerate(grams)] + [""]
    for n, g in enumerate(grams):
        lines.append(f"\\{n + 1}-grams:")
        for toks in g:
            back = f"\t{-rng.uniform(0.0, 0.8):.4f}" if n < 2 else ""
            lines.append(f"{-rng.uniform(0.2, 2.5):.4f}\t{' '.join(toks)}{back}")
        lines.append("")
    path.write_text("\n".join(lines + ["\\end\\", ""]))
    return path


def ctc_fairseq_state_dict(model):
    """The port's Wav2VecCtcModel in a fairseq ``Wav2VecCtc`` checkpoint's
    layout (the inverse of ``import_wav2vec_ctc_state_dict``): the
    positional conv weight-normed (``weight_g`` its norm over dims 0 and 1,
    ``weight_v`` a rescaled copy)."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    key = "w2v_encoder.w2v_model.encoder.pos_conv.0."
    w = sd.pop(key + "weight")
    sd[key + "weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[key + "weight_v"] = 0.5 * w
    return sd


def make_w2v_fixture(torch, root: Path, seed: int = 89) -> dict:
    """Writes, with the port's own code: ``asr/`` (24 seeded wavs of 2-16 s
    as ``test`` and ``train``, 8 of them as ``valid``, the 2 shortest as
    ``parity``; letter transcripts, fairseq's 32-entry dictionary, a seeded
    3-gram ARPA LM), ``pretrain/`` (10 wavs of 16-20 s; 5 of them
    ``valid``), ``bimodal/`` (the same with a second aligned stream), a
    fairseq-layout ``Wav2VecCtc`` ``.pt`` at wav2vec 2.0 base width (12 x
    768, 12 heads, the default conv spec, ``mask_emb``) with seeded weights,
    read back through the ported importer (every tensor equal, the folded
    weight norm to 1e-6) and written as a native ``.ckpt``, and a native
    ``.ckpt`` of ``wav2vec_seq2seq`` on a trunk of the same widths."""
    from argparse import Namespace

    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.checkpoint.torch_import import (
        import_wav2vec_ctc_state_dict,
        load_torch_checkpoint,
    )
    from chimera_st_tpu_torch.data.audio import write_wav
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.tasks import setup_task

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    asr, pre, bim = root / "asr", root / "pretrain", root / "bimodal"
    for d in (asr, pre, bim):
        d.mkdir(parents=True)
    (asr / "dict.ltr.txt").write_text("".join(f"{c} {1000 - i}\n"
                                              for i, c in enumerate(W2V_LETTERS)))
    rows, labels = [], []
    for i in range(ASR_WAVS):
        n = 320 * int(rng.integers(100, 801))  # 2.0 .. 16.0 s
        write_wav(str(asr / f"u{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32))
        rows.append((f"u{i}.wav", n))
        labels.append(letter_line(rng))
    shortest = sorted(range(ASR_WAVS), key=lambda j: rows[j][1])[:ASR_PARITY_WAVS]
    for split, idx in (("test", range(ASR_WAVS)), ("train", range(ASR_WAVS)),
                       ("valid", range(8)), ("parity", shortest)):
        write_manifest(asr, split, [rows[j] for j in idx], [labels[j] for j in idx])
    arpa = seeded_letter_arpa(asr / "letters_3gram.arpa", seed)
    pre_rows, bim_rows = [], []
    for i in range(PRETRAIN_WAVS):
        n = 320 * int(rng.integers(800, 1001))  # 16.0 .. 20.0 s
        write_wav(str(pre / f"p{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32))
        write_wav(str(bim / f"a{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32))
        write_wav(str(bim / f"b{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32))
        pre_rows.append((f"p{i}.wav", n))
        bim_rows.append((f"a{i}.wav", n, f"b{i}.wav", n))
    for d, r in ((pre, pre_rows), (bim, bim_rows)):
        write_manifest(d, "train", r)
        write_manifest(d, "valid", r[:5])

    task = setup_task({"_name": "audio_pretraining", "data": str(asr), "labels": "ltr"})
    model = init_params_(task.build_model(dict(ASR_CTC), device="cpu", train=True),
                         torch.Generator().manual_seed(seed)).eval()
    pt = asr / "wav2vec_ctc_seeded.pt"
    w2v_args = Namespace(encoder_embed_dim=768, encoder_ffn_embed_dim=3072, encoder_layers=12,
                         encoder_attention_heads=12, conv_feature_layers=W2V_CONV_FEATURE_LAYERS,
                         extractor_mode="default", conv_bias=False)
    torch.save({"args": Namespace(arch="wav2vec_ctc", w2v_args=w2v_args),
                "model": ctc_fairseq_state_dict(model)}, str(pt))
    imported = import_wav2vec_ctc_state_dict(load_torch_checkpoint(str(pt))["model"])
    seeded = model.state_dict()
    worst = max(max_err(imported[k], seeded[k]) for k in seeded)
    if sorted(imported) != sorted(seeded):
        raise AssertionError("the imported Wav2VecCtc keys are not the model's")
    check("asr fixture: the .pt through import_wav2vec_ctc_state_dict vs the seeded model",
          worst, 1e-6)
    model.load_state_dict(imported, strict=True)
    ctc = asr / "wav2vec_ctc.ckpt"
    save_model(str(ctc), model, ASR_CTC)
    n_ctc = sum(p.numel() for p in model.parameters())
    s2s_model = init_params_(task.build_model(dict(ASR_S2S), device="cuda", train=True),
                             torch.Generator(device="cuda").manual_seed(seed + 1))
    s2s = asr / "wav2vec_seq2seq.ckpt"
    save_model(str(s2s), s2s_model, ASR_S2S)
    n_s2s = sum(p.numel() for p in s2s_model.parameters())
    log(f"w2v fixture: {ASR_WAVS} wavs, {sum(r[1] for r in rows) / 16000:.1f} s of audio; "
        f"{PRETRAIN_WAVS} pre-training wavs ({sum(r[1] for r in pre_rows) / 16000:.1f} s) and "
        f"as many aligned pairs; wav2vec_ctc {n_ctc / 1e6:.1f} M parameters ({pt.name} "
        f"{pt.stat().st_size / 1e6:.0f} MB), wav2vec_seq2seq {n_s2s / 1e6:.1f} M; "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(root=root, asr=asr, pretrain=pre, bimodal=bim, arpa=arpa, ctc=ctc, s2s=s2s,
                audio_s={s: sum(rows[j][1] for j in idx) / 16000 for s, idx in
                         (("test", range(ASR_WAVS)), ("parity", shortest))})


ASR_TASK = ["--task", "audio_pretraining", "--labels", "ltr"]


def asr_generate(fx, ckpt: Path, out_dir: Path, subset: str, extra):
    """cli.generate of an ASR checkpoint -> (output text, counts and times)."""
    from chimera_st_tpu_torch.cli import generate

    out_dir.mkdir(parents=True, exist_ok=True)
    stats = generate.main([str(fx["asr"]), *ASR_TASK, "--path", str(ckpt), "--gen-subset",
                           subset, "--max-tokens", ASR_MAX_TOKENS, "--results-path",
                           str(out_dir), *extra])
    return (out_dir / f"generate-{subset}.txt").read_text(), stats


def asr_lines(text: str):
    """{sample id: (score, hypothesis)} from the H- lines, {sample id:
    reference} from the T- lines, the last line."""
    h, t = {}, {}
    for line in text.splitlines():
        head, _, rest = line.partition("\t")
        if head[:2] == "H-" and head[2:].isdigit():
            score, _, hyp = rest.partition("\t")
            h[int(head[2:])] = (float(score), hyp)
        elif head[:2] == "T-" and head[2:].isdigit():
            t[int(head[2:])] = rest
    return h, t, (text.strip().splitlines() or [""])[-1]


@contextlib.contextmanager
def counted_calls(cls, name: str = "forward"):
    """While open, counts the calls of ``cls.<name>`` (eval-mode calls and
    all calls: [all, in eval mode])."""
    n = [0, 0]
    real = getattr(cls, name)

    def counted(self, *args, **kwargs):
        n[0] += 1
        n[1] += int(not self.training)
        return real(self, *args, **kwargs)

    setattr(cls, name, counted)
    try:
        yield n
    finally:
        setattr(cls, name, real)


def asr_batches(fx, subset: str, max_tokens=ASR_MAX_TOKENS) -> int:
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "audio_pretraining", "data": str(fx["asr"]), "labels": "ltr"})
    task.load_dataset(subset)
    return len(task.make_batch_iterator(task.dataset(subset), max_tokens=int(max_tokens)))


def phase_asr_serve(torch, fx, kernels):
    """The slice's main path: cli.generate --task audio_pretraining --labels
    ltr of the seeded wav2vec_ctc checkpoint (base width, 12 heads, 32
    letters). fp32 card vs CPU on the 2 shortest wavs, greedy (beam 1) and
    prefix beam 50 fused with the seeded 3-gram ARPA LM: hypotheses
    identical. Then bf16: greedy on the 24 wavs (--max-tokens 1280000), the
    counts zeroed before and read after (K2 6 and K1 12 a batch, exact), a
    run under --profile (the busy share), and beam 50 + LM on the parity
    wavs. Prints {"asr_serve": {...}}; returns the launches."""
    work = fx["root"] / "asr_serve"
    beam = ASR_BEAM + ["--ctc-lm-path", str(fx["arpa"])]
    rec = {}
    for name, flags in (("greedy", ["--beam", "1"]), ("beam50_lm", beam)):
        t0 = time.perf_counter()
        gtext, _ = asr_generate(fx, fx["ctc"], work / f"parity_{name}_cuda", "parity",
                                ["--dtype", "float32", *flags])
        t1 = time.perf_counter()
        ctext, _ = asr_generate(fx, fx["ctc"], work / f"parity_{name}_cpu", "parity",
                                ["--dtype", "float32", "--device", "cpu", *flags])
        (gh, gt, gl), (ch, ct, cl) = asr_lines(gtext), asr_lines(ctext)
        if ({k: v[1] for k, v in gh.items()} != {k: v[1] for k, v in ch.items()} or gt != ct
                or len(gh) != ASR_PARITY_WAVS or gl != cl):
            raise AssertionError(f"asr_serve fp32 {name}: card {gh} vs CPU {ch}")
        worst = max(abs(gh[k][0] - ch[k][0]) for k in gh)
        # a sum of ~100 frames' log-probabilities, printed with 4 decimals
        check(f"asr_serve fp32 {name}: {len(gh)} hypotheses identical card vs CPU (card "
              f"{t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s); scores", worst, 1e-3)
        log(f"  {gl}")
        rec[f"parity_{name}"] = {"identical": True, "hypotheses": len(gh), "score_err": worst}
    n_batches = asr_batches(fx, "test")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text, stats = asr_generate(fx, fx["ctc"], work / "serve", "test",
                               ["--dtype", "bfloat16", "--beam", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in kernels}
    implied = {"encoder_attention": 12 * n_batches, "conv_tail": 6 * n_batches,
               "decode_attention": 0, "logmel": 0}
    hyps, _, last = asr_lines(text)
    audio_s = fx["audio_s"]["test"]
    rec["greedy"] = dict(utterances=stats["sentences"], batches=n_batches, wall_s=wall,
                         decode_s=stats["decode_s"], load_s=stats["load_s"],
                         utterances_per_s=stats["sentences"] / stats["decode_s"],
                         audio_s_per_s=audio_s / stats["decode_s"], wer=stats["wer"],
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                         launches=counts, launches_per_batch={k: v / n_batches for k, v
                                                              in counts.items()})
    log(f"asr_serve bf16 greedy: {stats['sentences']} utterances ({audio_s:.1f} s of audio) in "
        f"{n_batches} batches, decode {stats['decode_s']:.2f} s = "
        f"{rec['greedy']['utterances_per_s']:.2f} utt/s, "
        f"{rec['greedy']['audio_s_per_s']:.1f} audio s/s; load {stats['load_s']:.2f} s; peak "
        f"{rec['greedy']['peak_memory_gb']:.2f} GB; launches {counts}; {last}")
    if counts != implied or len(hyps) != ASR_WAVS:
        raise AssertionError(f"asr_serve: launches {counts} (want {implied}), {len(hyps)} "
                             "hypotheses")
    asr_generate(fx, fx["ctc"], work / "profiled", "test",
                 ["--dtype", "bfloat16", "--beam", "1", "--profile", str(work / "trace")])
    rec["greedy"]["busy"] = trace_busy(work / "trace" / "trace.json")
    log(f"  under --profile: device busy {100 * rec['greedy']['busy']['busy_share']:.1f} % of "
        f"{rec['greedy']['busy']['wall_ms']:.0f} ms")
    t0 = time.perf_counter()
    _, stats = asr_generate(fx, fx["ctc"], work / "serve_beam", "parity",
                            ["--dtype", "bfloat16", *beam])
    rec["beam50_lm"] = dict(utterances=stats["sentences"], decode_s=stats["decode_s"],
                            utterances_per_s=stats["sentences"] / stats["decode_s"],
                            audio_s_per_s=fx["audio_s"]["parity"] / stats["decode_s"])
    log(f"asr_serve bf16 prefix beam 50 + 3-gram LM: {stats['sentences']} utterances "
        f"({fx['audio_s']['parity']:.1f} s of audio) in {stats['decode_s']:.2f} s "
        f"({rec['beam50_lm']['utterances_per_s']:.2f} utt/s; the host's beam search)")
    print(json.dumps({"asr_serve": rec}), flush=True)
    return counts


def phase_asr_seq2seq(torch, fx, kernels):
    """wav2vec_seq2seq (the decoder 10 x 1,024, 16 heads, untied output) on
    a trunk of the same widths: fp32 card vs CPU on the 2 parity wavs at
    PARITY_DECODE steps, tokens identical; bf16 on the 24 wavs at beam 5,
    64 steps, K1 12 and K2 6 a batch, K3 10 a decoder step. Prints
    {"asr_seq2seq": {...}}; returns the launches."""
    work = fx["root"] / "asr_seq2seq"
    common = ["--autoregressive", "--beam", "5", "--scoring", "wer"]
    t0 = time.perf_counter()
    gtext, _ = asr_generate(fx, fx["s2s"], work / "parity_cuda", "parity",
                            [*common, "--dtype", "float32", *PARITY_DECODE])
    t1 = time.perf_counter()
    ctext, _ = asr_generate(fx, fx["s2s"], work / "parity_cpu", "parity",
                            [*common, "--dtype", "float32", "--device", "cpu", *PARITY_DECODE])
    (gh, gfull, _), (ch, cfull, _) = parse_protocol(gtext), parse_protocol(ctext)
    same_hypotheses("asr_seq2seq fp32 card vs CPU", gh, ch, ASR_PARITY_WAVS)
    log(f"  card {t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s")
    n_batches = asr_batches(fx, "test")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    with counted_decoder_steps() as steps:
        text, stats = asr_generate(fx, fx["s2s"], work / "serve", "test",
                                   [*common, "--dtype", "bfloat16", "--max-decode-len", "64"])
        torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in kernels}
    implied = {"encoder_attention": 12 * n_batches, "conv_tail": 6 * n_batches,
               "decode_attention": 10 * steps[0], "logmel": 0}
    hyps, full, last = parse_protocol(text)
    rec = dict(utterances=stats["sentences"], batches=n_batches, decoder_steps=steps[0],
               decode_s=stats["decode_s"], load_s=stats["load_s"],
               utterances_per_s=stats["sentences"] / stats["decode_s"], launches=counts)
    log(f"asr_seq2seq bf16 beam 5: {stats['sentences']} utterances in {n_batches} batches, "
        f"{steps[0]} decoder steps, decode {stats['decode_s']:.2f} s = "
        f"{rec['utterances_per_s']:.2f} utt/s, load {stats['load_s']:.2f} s; launches {counts}; "
        f"{last}")
    if counts != implied or len(full) != ASR_WAVS or not steps[0]:
        raise AssertionError(f"asr_seq2seq: launches {counts} (want {implied}), {len(full)}")
    print(json.dumps({"asr_seq2seq": rec}), flush=True)
    return counts


def asr_train_argv(fx, save_dir: Path, max_update: int):
    """fairseq's examples/wav2vec README base fine-tune under the names the
    JAX train CLI reads (the flags it does not read left out: PERF.md §4),
    the tri_stage phases cut to ``max_update``."""
    return [str(fx["asr"]), *ASR_TASK, "--arch", "wav2vec_ctc", *[
        x for k, v in W2V_BASE.items() for x in (f"--{k.replace('_', '-')}", str(v))],
        "--apply-mask", "--mask-prob", "0.5", "--layerdrop", "0.1", "--feature-grad-mult",
        "0.0", "--freeze-finetune-updates", "1", "--zero-infinity", "--final-dropout", "0.0",
        "--criterion", "ctc", "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
        "--adam-eps", "1e-08", "--lr", "2e-05", "--lr-scheduler", "tri_stage",
        "--phase-ratio", "[0.1, 0.4, 0.5]", "--final-lr-scale", "0.05",
        "--max-update", str(max_update), "--max-tokens", ASR_MAX_TOKENS,
        "--best-checkpoint-metric", "wer", "--dtype", "bfloat16", "--log-interval", "1",
        "--save-dir", str(save_dir)]


def k1_backward_share(path: Path) -> dict:
    """The plain K1 backward's share of a traced run: the device time of
    the kernels launched inside ``EncoderAttentionFnBackward`` (matched to
    their launches by correlation id) over the device's busy time and over
    the trace's span."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    spans = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in xs
                       if "EncoderAttentionFnBackward" in str(e.get("name", ""))):
        if spans and a <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], b))
        else:
            spans.append((a, b))
    launches = {}
    for e in xs:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    inside = 0.0
    import bisect

    starts = [a for a, _ in spans]
    for e in xs:
        if e.get("cat") != "kernel":
            continue
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            inside += float(e.get("dur", 0))
    busy = trace_busy(path)
    return {"k1_backward_device_ms": inside / 1e3, "backward_spans": len(spans),
            "share_of_device_busy": inside / 1e3 / busy["device_busy_ms"],
            "share_of_wall": inside / 1e3 / busy["wall_ms"], **busy}


def asr_update_profile(torch, fx):
    """One bf16 update of the fine-tune's model (base width, the README's
    rates, layerdrop 0 so that all 12 layers run) on the largest train
    micro-batch under torch.profiler, after one warm-up update:
    k1_backward_share of its trace."""
    from torch.profiler import ProfilerActivity, profile

    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    task = setup_task({"_name": "audio_pretraining", "data": str(fx["asr"]), "labels": "ltr",
                       "mask_prob": 0.5})
    task.load_dataset("train")
    batch = next(iter(task.make_batch_iterator(task.dataset("train"),
                                               max_tokens=int(ASR_MAX_TOKENS))
                      .next_epoch_itr(shuffle=False)))
    model = init_params_(task.build_model(dict(ASR_CTC), device="cuda", train=True),
                         torch.Generator(device="cuda").manual_seed(7))
    step = TrainStep(model, task.build_criterion({"_name": "ctc"}),
                     build_optimizer(TRAIN_ADAM, model.parameters()),
                     build_lr_schedule({"_name": "fixed", "lr": 2e-5}))
    step.num_updates = 5  # past the freeze horizon: the trunk trains
    step([batch])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step([batch])
        torch.cuda.synchronize()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        out = k1_backward_share(path)
    out["batch"] = list(batch["audio"].shape)
    del model, step
    torch.cuda.empty_cache()
    return out


def asr_step_parity(torch, fx, label: str):
    """One fp32 update card vs CPU of wav2vec_ctc at 2 trunk layers (widths
    kept), layerdrop 0, every dropout 0, the span mask given, past the
    freeze horizon: compare_step's gates."""
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    task = setup_task({"_name": "audio_pretraining", "data": str(fx["asr"]), "labels": "ltr",
                       "mask_prob": 0.5})
    task.load_dataset("parity")
    batch = next(iter(task.make_batch_iterator(task.dataset("parity"), max_sentences=2)
                      .next_epoch_itr(shuffle=False)))
    cfg = dict(ASR_CTC, w2v2_layers=2, freeze_finetune_updates=1)
    weights = init_params_(task.build_model(dict(cfg), device="cpu", train=True),
                           torch.Generator().manual_seed(3)).state_dict()
    out = {}
    for device in ("cuda", "cpu"):
        model = task.build_model(dict(cfg), device=device, train=True)
        model.load_state_dict(weights)
        step = TrainStep(model, task.build_criterion({"_name": "ctc"}),
                         build_optimizer(TRAIN_ADAM, model.parameters()),
                         build_lr_schedule({"_name": "fixed", "lr": 1e-4}),
                         compute_dtype=torch.float32)
        step.num_updates = 5
        before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        metrics = step([batch])
        out[device] = (metrics, before, {k: p.grad.cpu() for k, p in model.named_parameters()},
                       {k: p.detach().cpu() for k, p in model.named_parameters()})
        log(f"  {label} {device}: loss {metrics['loss']:.4f}, gnorm {metrics['gnorm']:.4f}")
        del model, step
    (mg, before, gg, pg), (mc, _, gc, pc) = out["cuda"], out["cpu"]
    return compare_step(torch, label, (mg, gg, pg), (mc, gc, pc), before, keys=("loss",))


def phase_asr_train(torch, fx, kernels):
    """The CTC fine-tune through cli.train with the README's base flags,
    bf16, to the end of epoch 1 (one WER validation and one save there),
    under --profile; then cli.generate of its checkpoint_best, and one fp32
    update card vs CPU at 2 layers. Launches exact: K2 6 a forward of the
    extractor (the training micro-batches, the loss and the WER passes over
    the valid split); K1 one a trunk layer that ran (training with
    attention dropout 0 runs it in every layer LayerDrop keeps; evaluation
    in all 12). Prints {"asr_train": {...}}; returns the launches."""
    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.models.wav2vec2 import ConvFeatureExtractor, W2V2EncoderLayer

    save_dir = fx["root"] / "asr_train"
    updates = asr_batches(fx, "train")  # one epoch
    n_valid = asr_batches(fx, "valid")
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_microbatches() as micro, counted_calls(W2V2EncoderLayer) as layers, \
            counted_calls(ConvFeatureExtractor) as extractor:
        out = train.main(asr_train_argv(fx, save_dir, updates))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = {fn.__name__: fn.launches for fn in kernels}
    t = out["times"]
    implied = {"encoder_attention": layers[0], "conv_tail": 6 * extractor[0],
               "decode_attention": 0, "logmel": 0}
    timed = t["update_s"][1:]
    audio_s = fx["audio_s"]["test"]  # the train split is the 24 wavs
    rec = dict(updates=out["trainer"].num_updates, micro_batches=micro[0],
               updates_per_s_after_first=len(timed) / sum(timed),
               audio_s_per_s=audio_s / t["epoch_s"][0], epoch_s=t["epoch_s"][0],
               valid_s=t["valid_s"], valid_wer=t["valid"], save_s=t["save_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, wall_s=wall,
               trunk_layer_calls=layers[0], eval_layer_calls=layers[1], launches=c)
    rec["profile"] = asr_update_profile(torch, fx)
    log(f"asr_train: {rec['updates']} updates ({micro[0]} micro-batches, one epoch of the 24 "
        f"wavs) in {wall:.1f} s; {rec['updates_per_s_after_first']:.3f} updates/s after the "
        f"first, {rec['audio_s_per_s']:.1f} audio s/s over the epoch; peak "
        f"{rec['peak_memory_gb']:.2f} GB; WER validation {t['valid']} in "
        f"{[round(s, 2) for s in t['valid_s']]} s; save {[round(s, 2) for s in t['save_s']]} s; "
        f"trunk layers run {layers[0]} ({layers[1]} in evaluation); launches {c}")
    log(f"  profile of one update (bf16, its largest micro-batch): device busy "
        f"{100 * rec['profile']['busy_share']:.1f} % of {rec['profile']['wall_ms']:.0f} ms; the "
        f"plain K1 backward {rec['profile']['k1_backward_device_ms']:.1f} ms = "
        f"{100 * rec['profile']['share_of_device_busy']:.1f} % of the device's busy time, "
        f"{100 * rec['profile']['share_of_wall']:.1f} % of the update "
        f"({rec['profile']['backward_spans']} backward spans)")
    if (c != implied or extractor[0] != micro[0] + 2 * n_valid
            or layers[1] != 12 * 2 * n_valid or not layers[0] - layers[1]
            or rec["updates"] != updates or len(t["valid"]) != 1):
        raise AssertionError(f"asr_train: launches {c} (want {implied}), extractor "
                             f"{extractor[0]}, layers {layers}, {rec['updates']} updates")
    for fn in kernels:
        fn.launches = 0
    text, stats = asr_generate(fx, save_dir / "checkpoint_best.ckpt", save_dir / "decode",
                               "valid", ["--dtype", "bfloat16", "--beam", "1"])
    dc = {fn.__name__: fn.launches for fn in kernels}
    hyps, _, last = asr_lines(text)
    if len(hyps) != 8 or dc["encoder_attention"] != 12 * n_valid:
        raise AssertionError(f"asr_train generate: {len(hyps)} hypotheses, {dc}")
    log(f"  cli.generate of checkpoint_best: 8 utterances, launches {dc}; {last}")
    rec["parity"] = asr_step_parity(torch, fx, "asr_train fp32 step (2 layers)")
    print(json.dumps({"asr_train": rec}), flush=True)
    return c, dc


def pretrain_argv(data: Path, save_dir: Path, task: str, arch: str, criterion: str,
                  max_update: int, extra=()):
    return [str(data), "--task", task, "--arch", arch, "--criterion", criterion,
            *PRETRAIN_FLAGS, "--max-update", str(max_update), "--save-dir", str(save_dir),
            *extra]


def pretrain_batches(data: Path, task_name: str, split: str) -> int:
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": task_name, "data": str(data), "max_sample_size": 250000,
                       "min_sample_size": 32000})
    task.load_dataset(split)
    return len(task.make_batch_iterator(task.dataset(split), max_tokens=1400000))


def pretrain_one(torch, label: str, argv, streams: int, n_valid: int, kernels):
    """One pre-training cli.train run, the counts zeroed before and read
    after. K2 6 a stream a micro-batch and a validation batch; K1 the 12
    layers a stream a validation batch (training: attention dropout 0.1, the
    plain path, as in JAX). -> (launches, record)."""
    from chimera_st_tpu_torch.cli import train

    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_microbatches() as micro:
        out = train.main(argv)
    torch.cuda.synchronize()
    c = {fn.__name__: fn.launches for fn in kernels}
    t = out["times"]
    implied = {"encoder_attention": streams * 12 * n_valid * len(t["valid_s"]),
               "conv_tail": 6 * streams * (micro[0] + n_valid * len(t["valid_s"])),
               "decode_attention": 0, "logmel": 0}
    timed = t["update_s"][1:]
    rec = dict(updates=out["trainer"].num_updates, micro_batches=micro[0],
               updates_per_s_after_first=len(timed) / sum(timed) if timed else None,
               update_s=t["update_s"], valid=t["valid"], valid_s=t["valid_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               wall_s=time.perf_counter() - t0, launches=c)
    log(f"  {label}: {rec['updates']} updates ({micro[0]} micro-batches) in "
        f"{rec['wall_s']:.1f} s, updates/s after the first "
        f"{rec['updates_per_s_after_first']}, peak {rec['peak_memory_gb']:.2f} GB, validation "
        f"{t['valid']}; launches {c}")
    if c != implied or not rec["updates"] or any(not np.isfinite(v) for v in t["valid"]):
        raise AssertionError(f"{label}: launches {c} (want {implied})")
    return c, rec


def pretrain_step_parity(torch, fx, label: str):
    """One fp32 pre-training update card vs CPU at 2 layers (widths kept):
    the criterion wav2vec, the Gumbel quantizer's uniform noise given (the
    same numbers on both devices), every dropout 0 (the trunk's attention
    dropout set to 0 on the instance), a micro-batch of 2 crops."""
    from chimera_st_tpu_torch.models import wav2vec2_pretraining as pt
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    task = setup_task({"_name": "audio_pretraining", "data": str(fx["pretrain"]),
                       "max_sample_size": 250000, "min_sample_size": 32000})
    task.load_dataset("valid")
    batch = next(iter(task.make_batch_iterator(task.dataset("valid"), max_sentences=2)
                      .next_epoch_itr(shuffle=False)))
    cfg = {"encoder_heads": 12, "encoder_layers": 2, "dropout": 0.0}
    weights = init_params_(task.build_model(dict(cfg), device="cpu", train=True),
                           torch.Generator().manual_seed(4)).state_dict()
    B, frames = batch["mask_indices"].shape
    noise = torch.from_numpy(np.random.default_rng(5).random((B * frames * 2, 320))
                             .astype(np.float32))
    real_noise = pt.uniform_noise
    pt.uniform_noise = lambda shape, generator, device: noise.to(device)
    out = {}
    try:
        for device in ("cuda", "cpu"):
            model = task.build_model(dict(cfg), device=device, train=True)
            model.load_state_dict(weights)
            for layer in model.wav2vec_model.encoder.layers:
                layer.self_attn.dropout = 0.0
            step = TrainStep(model, task.build_criterion({"_name": "wav2vec"}),
                             build_optimizer(TRAIN_ADAM, model.parameters()),
                             build_lr_schedule({"_name": "fixed", "lr": 1e-4}),
                             compute_dtype=torch.float32)
            before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
            t0 = time.perf_counter()
            metrics = step([batch])
            out[device] = (metrics, before,
                           {k: p.grad.cpu() for k, p in model.named_parameters()},
                           {k: p.detach().cpu() for k, p in model.named_parameters()})
            log(f"  {label} {device}: {time.perf_counter() - t0:.2f} s, loss "
                f"{metrics['loss']:.4f}, gnorm {metrics['gnorm']:.4f}")
            del model, step
    finally:
        pt.uniform_noise = real_noise
    (mg, before, gg, pg), (mc, _, gc, pc) = out["cuda"], out["cpu"]
    # the InfoNCE logits are cosine similarities over the logit
    # temperature 0.1, which scales the trunk's fp32 differences (K1 / K2 on
    # the card, the plain versions on the CPU) tenfold before ~800 masked
    # frames are summed: the losses 1e-4 relative; gnorm, every gradient
    # and the update are held by compare_step's gates
    for key in ("loss", "contrastive_loss", "features_pen"):
        check(f"{label} {key} card vs CPU (relative)", abs(mg[key] - mc[key]) / abs(mc[key]),
              1e-4)
    return compare_step(torch, label, (mg, gg, pg), (mc, gc, pc), before, keys=())


def phase_w2v_pretrain(torch, fx, kernels):
    """wav2vec 2.0 pre-training through cli.train at base width (12 heads),
    bf16: 2 updates (one epoch) of crops of 250,000 samples (5 a batch) and
    one validation; K2 forward and backward (ConvTailFn) in every micro-batch;
    then one fp32 update card vs CPU at 2 layers. Prints
    {"w2v_pretrain": {...}}; returns the launches."""
    data = fx["pretrain"]
    n_valid = pretrain_batches(data, "audio_pretraining", "valid")
    log(f"w2v_pretrain: cli.train --task audio_pretraining --arch wav2vec2, "
        f"{PRETRAIN_WAVS} wavs of 16-20 s, {n_valid} validation batch(es)")
    c, rec = pretrain_one(torch, "w2v_pretrain", pretrain_argv(
        data, fx["root"] / "w2v_pretrain", "audio_pretraining", "wav2vec2", "wav2vec", 2),
        1, n_valid, kernels)
    rec["parity"] = pretrain_step_parity(torch, fx, "w2v_pretrain fp32 step (2 layers)")
    print(json.dumps({"w2v_pretrain": rec}), flush=True)
    return c


def v1_update(torch, fx):
    """One bf16 update of wav2vec v1 (its default conv stacks, 12 steps
    ahead, 10 negatives) through TrainStep on the pre-training crops; no
    kernel runs on this path."""
    from chimera_st_tpu_torch.data.raw_audio_dataset import RawAudioDataset
    from chimera_st_tpu_torch.models import wav2vec_v1
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    cfg = wav2vec_v1.Wav2VecV1Config()
    ds = RawAudioDataset.from_tsv(str(fx["pretrain"] / "valid.tsv"), str(fx["pretrain"]),
                                  num_negatives=cfg.num_negatives,
                                  frames_fn=lambda n: wav2vec_v1.feature_length(n, cfg))
    batch = ds.collater([ds[i] for i in range(2)])
    model = init_params_(wav2vec_v1.build_wav2vec_v1({}, device="cuda").train(),
                         torch.Generator(device="cuda").manual_seed(6))
    task = setup_task({"_name": "audio_pretraining", "data": str(fx["pretrain"])})
    step = TrainStep(model, task.build_criterion({"_name": "wav2vec_v1"}),
                     build_optimizer(TRAIN_ADAM, model.parameters()),
                     build_lr_schedule({"_name": "fixed", "lr": 1e-4}))
    t0 = time.perf_counter()
    m = step([batch])
    torch.cuda.synchronize()
    return {"loss": m["loss"], "gnorm": m["gnorm"], "s": time.perf_counter() - t0,
            "params_m": sum(p.numel() for p in model.parameters()) / 1e6}


def phase_bimodal_pretrain(torch, fx, kernels):
    """Chimera's bimodal pre-training: cli.train --task bimodal_pretraining
    --arch wav2vec2_quasiwave, 2 updates each with wav2vec_bimodal and with
    aligning_loss_bimodal (two streams: K2 12 a micro-batch), then one
    update of the k-means quantizer (--quantizer-type kmeans) and one of
    wav2vec v1 (TrainStep). Prints {"bimodal_pretrain": {...}}; returns the
    launches."""
    data = fx["bimodal"]
    n_valid = pretrain_batches(data, "bimodal_pretraining", "valid")
    counts, rec = {}, {}
    for crit in ("wav2vec_bimodal", "aligning_loss_bimodal"):
        counts[f"bimodal_{crit}"], rec[crit] = pretrain_one(
            torch, f"bimodal_pretrain {crit}", pretrain_argv(
                data, fx["root"] / f"bimodal_{crit}", "bimodal_pretraining",
                "wav2vec2_quasiwave", crit, 2, ["--no-save"]), 2, n_valid, kernels)
    n_valid = pretrain_batches(fx["pretrain"], "audio_pretraining", "valid")
    counts["kmeans"], rec["kmeans"] = pretrain_one(
        torch, "w2v_pretrain kmeans quantizer", pretrain_argv(
            fx["pretrain"], fx["root"] / "kmeans", "audio_pretraining", "wav2vec2", "wav2vec", 1,
            ["--quantizer-type", "kmeans", "--no-save"]), 1, n_valid, kernels)
    rec["wav2vec_v1"] = v1_update(torch, fx)
    log(f"  wav2vec v1: one bf16 update, loss {rec['wav2vec_v1']['loss']:.2f}, "
        f"{rec['wav2vec_v1']['params_m']:.1f} M parameters, {rec['wav2vec_v1']['s']:.2f} s")
    print(json.dumps({"bimodal_pretrain": rec}), flush=True)
    return counts


def phase_w2v_shapes(torch, ops, seen, records):
    """K1, K2 and K3 at every shape the wav2vec phases launched, against
    the plain versions in bf16 and fp32; timed: the largest K1 (with SDPA)
    and K2 shape, K3 at the seq2seq decode's largest; K2's backward at the
    pre-training crop (B 5 x 250,000 samples) with cuDNN's forward +
    backward beside it (its plain version)."""
    def area(p):
        return p[0][0] * p[0][1]

    k1, k2, k3 = seen["encoder_attention"], seen["conv_tail"], seen["decode_attention"]
    crop = [p for p in k2 if p[0][1] == PRETRAIN_T1]  # the pre-training crop
    timed = {"encoder_attention": list(dict.fromkeys(
                 [p for p in k1 if p[0][1] == PRETRAIN_T][:1] + [max(k1, key=area)])),
             "conv_tail": list(dict.fromkeys(crop[:1] + [max(k2, key=area)])),
             "decode_attention": [max(k3, key=lambda p: p[0][0] * p[0][2])]}
    rest = {k: [p for p in v if p not in timed[k]] for k, v in seen.items()}
    phase_shapes(torch, ops, timed, records, "w2v", lambda sh: (
        (12, 64) in {(H, D) for _, _, H, D in sh["encoder_attention"]}
        and bool(sh["conv_tail"]) and (16, 5) in {(H, C) for _, H, _, _, C
                                                  in sh["decode_attention"]}),
        timed=("encoder_attention", "conv_tail", "decode_attention"))
    phase_shapes(torch, ops, rest, records, "w2v_all", lambda sh: True)
    if not crop:
        raise AssertionError(f"w2v_shapes: no K2 launch at the pre-training crop: {k2}")
    B, T1, _ = crop[0][0]
    conv_tail = ops[1]
    rec = next(r for r in records if r["name"] == "conv_tail")
    tensor = Inputs(torch, 8)
    back = k2_backward_case(torch, conv_tail, tensor, B, T1)
    CH = conv_tail.CH
    x = torch.nn.functional.gelu(tensor((B, T1, CH), dtype=torch.float32)).to(torch.bfloat16)
    ws = [tensor((CH, CH, k), scale=(2.0 / (k * CH)) ** 0.5) for k, _ in conv_tail.TAIL_SPEC]
    g = tensor(tuple(conv_tail.conv_tail_plain(x, ws).shape))

    def cudnn_forward_backward():
        leaves = [x.detach().requires_grad_()] + [w.detach().requires_grad_() for w in ws]
        conv_tail.conv_tail_plain(leaves[0], leaves[1:]).backward(g)

    back["backward_library_ms"] = cuda_ms(cudnn_forward_backward, reps=3)
    log(f"  B{B} T1 {T1} cuDNN forward + backward (bf16): {back['backward_library_ms']:.3f} ms")
    rec.setdefault("backward", {})[f"w2v_pretrain_B{B}_T1_{T1}"] = back
    torch.cuda.empty_cache()


# ---- the masked-LM family (RoBERTa / BERT / XLM): roberta_large served
# through the hub and cli.validate, roberta_base trained with fairseq's
# README flags, the rest of the family one or two updates each

MLM_BPE_SYMBOLS = 50_257  # GPT-2's encoder.json
MLM_MADEUP = 3  # fairseq RoBERTa's dict.txt ends with madeupword0000..0002
MLM_VOCAB = 4 + MLM_BPE_SYMBOLS + MLM_MADEUP + 1  # 50,265 rows: specials, dict.txt, <mask>
MLM_SERVE = {"arch": "roberta_large", "dropout": 0.1}  # 24 x 1,024, FFN 4,096, 16 heads of 64
MLM_SERVE_LAYERS = 24
MLM_BATCH = 16
MLM_SERVE_BATCHES = 3  # of 16 rows of 64-512 tokens, the first of each 512
MLM_PARITY_LAYERS = 2  # the fp32 card-vs-CPU hub and update (widths kept)
MLM_FILL_SENTENCES = 4
MLM_WORDS = 400  # the seeded words the fixture's BPE merges spell
MLM_SENTS = {"train": 96, "valid": 16}  # of 30-240 tokens: 1 validation batch of blocks
MLM_TOKENS_PER_SAMPLE = 512
# fairseq examples/roberta/README.pretraining.md; --update-freq 16 -> 1 and
# --warmup-updates 10000 -> 1 (--total-num-update 125000 -> 10) for the
# script's time limit
MLM_README = ["--tokens-per-sample", str(MLM_TOKENS_PER_SAMPLE), "--sample-break-mode",
              "complete", "--optimizer", "adam", "--adam-betas", "(0.9,0.98)", "--adam-eps",
              "1e-6", "--weight-decay", "0.01", "--clip-norm", "0.0", "--lr-scheduler",
              "polynomial_decay", "--lr", "0.0005", "--warmup-updates", "1",
              "--total-num-update", "10", "--dropout", "0.1", "--attention-dropout", "0.1",
              "--max-sentences", str(MLM_BATCH), "--update-freq", "1", "--dtype", "bfloat16",
              "--log-interval", "1", "--num-workers", "1"]
# the rest of the family: arch, task flags, criterion, encoder layers
MLM_XLM = {"arch": "xlm_base"}  # 6 x 1,024, FFN 4,096, 8 heads of 128
MLM_MT_WIDTHS = ["--encoder-embed-dim", "1024", "--encoder-ffn-dim", "4096", "--encoder-layers",
                 "6", "--encoder-heads", "8", "--decoder-embed-dim", "1024", "--decoder-ffn-dim",
                 "4096", "--decoder-layers", "6", "--decoder-heads", "8", "--activation", "gelu"]
MLM_MT_PAIRS = {"train": 64, "valid": 8, "test": 16}
MLM_MT_TOKENS = 2048
MLM_DECODE = ["--beam", "5", "--max-decode-len", "64"]


def gpt2_fixture(rng, root: Path, n_words: int):
    """A seeded GPT-2 BPE: encoder.json (the 256 byte symbols, the merges
    that spell ``n_words`` seeded words with and without the leading-space
    marker, fillers up to GPT-2's 50,257) and vocab.bpe -> (the BPE config,
    the words)."""
    b2u = {}
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
                 + list(range(0xAE, 0x100)))
    shift = 0
    for b in range(256):
        if b in printable:
            b2u[b] = chr(b)
        else:
            b2u[b] = chr(256 + shift)
            shift += 1
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, int(rng.integers(3, 9))))
                    for _ in range(n_words)})
    merges = {}
    for w in words:
        for word in ("Ġ" + w, w):
            cur = word[0]
            for c in word[1:]:
                merges.setdefault((cur, c), None)
                cur += c
    symbols = list(dict.fromkeys([b2u[b] for b in range(256)] + ["".join(m) for m in merges]))
    symbols += [f"<filler{i}>" for i in range(MLM_BPE_SYMBOLS - len(symbols))]
    (root / "encoder.json").write_text(json.dumps({s: i for i, s in enumerate(symbols)}))
    (root / "vocab.bpe").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return {"_name": "gpt2", "gpt2_encoder_json": str(root / "encoder.json"),
            "gpt2_vocab_bpe": str(root / "vocab.bpe")}, words


def mlm_rows(rng, n: int, lengths, p):
    """n rows of dictionary indices (Zipf over the BPE ids), eos last."""
    out = []
    for _ in range(n):
        ids = rng.choice(MLM_BPE_SYMBOLS, size=int(rng.integers(*lengths)) - 1, p=p) + 4
        out.append(np.concatenate([ids, [2]]).astype(np.int32))
    return out


def make_mlm_fixture(root: Path, seed: int = 97) -> dict:
    """Seeded data for the masked-LM phases, binarized with the port's
    ``MMapIndexedDatasetBuilder``: a GPT-2 BPE and fairseq RoBERTa's 50,260-line dict.txt of its
    ids (``mlm``: train / valid sentences of 30-240 tokens), per-language
    folders for cross_lingual_lm (``xlm``: en, fr), de-en pairs whose
    dictionaries are the masked LM's with ``<mask>`` (``mt``: the XLM warm
    start copies the embeddings too), and the rows the hub serves."""
    from chimera_st_tpu_torch.data.indexed_dataset import MMapIndexedDatasetBuilder

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    for d in ("mlm", "xlm/en", "xlm/fr", "mt"):
        (root / d).mkdir(parents=True)
    bpe_cfg, words = gpt2_fixture(rng, root, MLM_WORDS)
    p = 1.0 / np.arange(1, MLM_BPE_SYMBOLS + 1) ** 1.1
    p /= p.sum()
    counts = np.maximum((p * 1e9).astype(np.int64), 1)
    lines = [f"{i} {c}\n" for i, c in enumerate(counts)]
    lines += [f"madeupword{i:04d} 0\n" for i in range(MLM_MADEUP)]
    for path in (root / "mlm" / "dict.txt", root / "xlm" / "dict.txt"):
        path.write_text("".join(lines))
    for lang in ("de", "en"):
        (root / "mt" / f"dict.{lang}.txt").write_text("".join(lines) + "<mask> 0\n")

    def write(prefix: Path, rows):
        b = MMapIndexedDatasetBuilder(str(prefix))
        for r in rows:
            b.add_item(r)
        b.finalize()

    for split, n in MLM_SENTS.items():
        write(root / "mlm" / split, mlm_rows(rng, n, (30, 241), p))
        for lang in ("en", "fr"):
            write(root / "xlm" / lang / split, mlm_rows(rng, n // 2, (30, 241), p))
    for split, n in MLM_MT_PAIRS.items():
        for lang in ("de", "en"):
            write(root / "mt" / f"{split}.de-en.{lang}", mlm_rows(rng, n, (8, 49), p))
    serve = []
    for _ in range(MLM_SERVE_BATCHES):
        lens = rng.integers(64, 513, size=MLM_BATCH)
        lens[0] = 512
        batch = np.full((MLM_BATCH, 512), 1, np.int32)  # pad 1; <s> ... </s>
        for i, n in enumerate(lens):
            ids = rng.choice(MLM_BPE_SYMBOLS, size=int(n) - 2, p=p) + 4
            batch[i, :n] = np.concatenate([[0], ids, [2]])
        serve.append(batch)
    sentences = [" ".join(rng.choice(words, int(rng.integers(4, 12))))
                 for _ in range(MLM_FILL_SENTENCES)]
    log(f"mlm fixture: GPT-2 BPE of {MLM_BPE_SYMBOLS} symbols, a {MLM_VOCAB}-row dictionary, "
        f"{sum(MLM_SENTS.values())} sentences, 2 x {sum(MLM_SENTS.values()) // 2} a language, "
        f"{sum(MLM_MT_PAIRS.values())} pairs; in {time.perf_counter() - t0:.1f} s")
    return dict(root=root, mlm=root / "mlm", xlm=root / "xlm", mt=root / "mt", bpe=bpe_cfg,
                serve=serve, sentences=sentences)


def mlm_task(fx):
    """The masked-LM task over the fixture (its dictionary with <mask>)."""
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({"_name": "masked_lm", "data": str(fx["mlm"])})
    if len(task.dictionary) != MLM_VOCAB:
        raise AssertionError(f"mlm dictionary of {len(task.dictionary)} rows")
    return task


def mlm_hub(fx, task, model):
    """The RoBERTa hub over ``model`` with the fixture's BPE and the task's
    dictionary."""
    from chimera_st_tpu_torch.data.encoders import build_bpe
    from chimera_st_tpu_torch.models.roberta_hub import RobertaHubInterface

    return RobertaHubInterface(model, task.dictionary, build_bpe(dict(fx["bpe"])))


def mlm_fills(hub, fx):
    """(tokens, position) of each fixture sentence through the BPE, its
    third token replaced by <mask>."""
    out = []
    for s in fx["sentences"]:
        t = hub.encode(s)
        t[2] = hub.dictionary.index("<mask>")
        out.append((t, 2))
    return out


def mlm_hub_parity(torch, fx, cfg: dict, label: str = "mlm_serve"):
    """fp32 card vs CPU through the hub at MLM_PARITY_LAYERS of roberta_large
    (widths kept): features of a padded batch (1e-3: fp32 matmuls at width
    1,024 and FFN 4,096 round differently on the two devices, K1 against
    its plain version), fill_mask's top 5 identical (probabilities 1e-4) and
    predict through a 3-class head (1e-4)."""
    from chimera_st_tpu_torch.models.interlingua import init_params_

    small = {**cfg, "layers": MLM_PARITY_LAYERS}
    task = mlm_task(fx)
    weights = init_params_(task.build_model(dict(small), device="cpu", train=True),
                           torch.Generator().manual_seed(11)).state_dict()
    rows = fx["serve"][0][:4]
    out = {}
    for device in ("cuda", "cpu"):
        model = task.build_model(dict(small), device=device)
        model.load_state_dict(weights)
        hub = mlm_hub(fx, task, model)
        hub.register_classification_head("nli", 3, seed=5)
        out[device] = (hub.extract_features(rows), [hub.fill_mask(t, pos) for t, pos
                                                    in mlm_fills(hub, fx)],
                       hub.predict("nli", rows))
    (fg, mg, pg), (fc, mc, pc) = out["cuda"], out["cpu"]
    check(f"{label} fp32 hub features card vs CPU (2 layers)", float(np.abs(fg - fc).max()),
          1e-3)
    for g, c in zip(mg, mc):
        if [t for t, _ in g] != [t for t, _ in c]:
            raise AssertionError(f"{label} fill_mask top 5 card {g} vs CPU {c}")
    check(f"{label} fp32 fill_mask: {len(mg)} top-5 lists identical; probabilities",
          max(abs(a[1] - b[1]) for g, c in zip(mg, mc) for a, b in zip(g, c)), 1e-4)
    check(f"{label} fp32 predict card vs CPU", float(np.abs(pg - pc).max()), 1e-4)
    return {"features_err": float(np.abs(fg - fc).max()), "fill_mask_identical": True,
            "predict_err": float(np.abs(pg - pc).max())}


def mlm_checkpoint(torch, fx, name: str, model_cfg: dict, seed: int) -> Path:
    """A native checkpoint of the masked LM ``model_cfg`` on the fixture's
    dictionary with seeded random weights (drawn on the card)."""
    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.models.interlingua import init_params_

    task = mlm_task(fx)
    t0 = time.perf_counter()
    model = init_params_(task.build_model(dict(model_cfg), device="cuda", train=True),
                         torch.Generator(device="cuda").manual_seed(seed))
    path = fx["root"] / f"{name}.ckpt"
    save_model(str(path), model, model_cfg)
    log(f"  {name}: {model_cfg['arch']}, {sum(q.numel() for q in model.parameters()) / 1e6:.1f} M "
        f"parameters, {path.stat().st_size / 1e9:.2f} GB written in "
        f"{time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    return path


def phase_mlm_serve(torch, fx, kernels):
    """The slice's main path: roberta_large (24 x 1,024, FFN 4,096, 16 heads
    of 64) over the fixture's 50,265-row dictionary, bf16, served through
    the RoBERTa hub from a native .ckpt: extract_features over
    MLM_SERVE_BATCHES batches of 16 rows of 64-512 tokens (K1 24 a batch),
    fill_mask on the fixture's sentences through the GPT-2 BPE (K1 24 a
    sentence) and predict through a registered 3-class head (K1 24), the
    counts zeroed before each and exact after; one more batch under
    torch.profiler (the busy share); then cli.validate --task masked_lm of
    the checkpoint (K1 24 a validation batch). First the fp32 card-vs-CPU
    hub at 2 layers. Prints {"mlm_serve": {...}}; returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from chimera_st_tpu_torch.cli import validate
    from chimera_st_tpu_torch.cli.generate import load_model_and_params

    rec = {"parity": mlm_hub_parity(torch, fx, MLM_SERVE)}
    ckpt = mlm_checkpoint(torch, fx, "roberta_large", MLM_SERVE, 13)
    task = mlm_task(fx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_model_and_params(str(ckpt), task, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    rec["load_s"] = time.perf_counter() - t0
    hub = mlm_hub(fx, task, model)
    hub.register_classification_head("nli", 3, seed=5)
    hub.extract_features(fx["serve"][0])  # warm-up
    counts = {}

    def counted(label, fn, implied):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        c = {k.__name__: k.launches for k in kernels}
        want = {"encoder_attention": implied, "conv_tail": 0, "decode_attention": 0,
                "logmel": 0}
        if c != want:
            raise AssertionError(f"mlm_serve {label}: launches {c} (want {want})")
        counts[label] = c
        return out, wall

    feats, wall = counted("features", lambda: [hub.extract_features(b) for b in fx["serve"]],
                          MLM_SERVE_LAYERS * MLM_SERVE_BATCHES)
    width = model.cfg.embed_dim
    if any(f.shape != (MLM_BATCH, 512, width) or not np.isfinite(f).all() for f in feats):
        raise AssertionError(f"mlm_serve: features not finite [16, 512, {width}]")
    n_tokens = sum(int((b != 1).sum()) for b in fx["serve"])
    rec["features"] = dict(sequences=MLM_BATCH * MLM_SERVE_BATCHES, tokens=n_tokens, wall_s=wall,
                           sequences_per_s=MLM_BATCH * MLM_SERVE_BATCHES / wall,
                           tokens_per_s=n_tokens / wall)
    fills = mlm_fills(hub, fx)
    tops, wall = counted("fill_mask", lambda: [hub.fill_mask(t, pos) for t, pos in fills],
                         MLM_SERVE_LAYERS * len(fills))
    rec["fill_mask"] = dict(sentences=len(fills), wall_s=wall, top5=[
        [tok for tok, _ in top] for top in tops])
    lp, wall = counted("predict", lambda: hub.predict("nli", fx["serve"][1]), MLM_SERVE_LAYERS)
    if lp.shape != (MLM_BATCH, 3) or not np.allclose(np.exp(lp).sum(1), 1.0, atol=1e-4):
        raise AssertionError(f"mlm_serve predict: {lp.shape} log-probs")
    rec["predict"] = dict(wall_s=wall)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hub.extract_features(fx["serve"][2])
        torch.cuda.synchronize()
    rec["busy"] = profiler_busy(prof)
    log(f"mlm_serve bf16 roberta_large: load {rec['load_s']:.2f} s; features "
        f"{rec['features']['sequences_per_s']:.1f} sequences/s, "
        f"{rec['features']['tokens_per_s']:.0f} tokens/s ({MLM_SERVE_BATCHES} batches of "
        f"{MLM_BATCH}, {n_tokens} tokens); fill_mask {len(fills)} sentences in "
        f"{rec['fill_mask']['wall_s']:.3f} s; predict {rec['predict']['wall_s']:.3f} s; peak "
        f"{rec['peak_memory_gb']:.2f} GB; a profiled batch busy "
        f"{100 * rec['busy']['busy_share']:.1f} % of {rec['busy']['wall_ms']:.0f} ms")
    del hub, model
    torch.cuda.empty_cache()
    n_valid = mlm_batches(fx["mlm"], {"_name": "masked_lm"}, "valid")
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    stats = validate.main([str(fx["mlm"]), "--task", "masked_lm", "--path", str(ckpt),
                           "--valid-subset", "valid", "--criterion", "masked_lm",
                           "--batch-size", str(MLM_BATCH), "--dtype", "bfloat16"])
    torch.cuda.synchronize()
    c = {k.__name__: k.launches for k in kernels}
    want = {"encoder_attention": MLM_SERVE_LAYERS * n_valid, "conv_tail": 0,
            "decode_attention": 0, "logmel": 0}
    rec["validate"] = dict(wall_s=time.perf_counter() - t0, batches=n_valid, **stats)
    log(f"  cli.validate --task masked_lm: {n_valid} batch(es), {stats} in "
        f"{rec['validate']['wall_s']:.1f} s; launches {c}")
    if c != want or not all(np.isfinite(v) for v in stats.values()):
        raise AssertionError(f"mlm_serve validate: launches {c} (want {want}), {stats}")
    counts["validate"] = c
    ckpt.unlink()
    print(json.dumps({"mlm_serve": rec}), flush=True)
    return {f"mlm_serve_{k}": v for k, v in counts.items()}


def mlm_batches(data: Path, task_cfg: dict, split: str, max_tokens=None) -> int:
    """The batches of ``split`` as the validation iterator packs them: at
    ``max_tokens``, else MLM_BATCH sentences."""
    from chimera_st_tpu_torch.tasks import setup_task

    task = setup_task({**task_cfg, "data": str(data)})
    task.load_dataset(split)
    return len(task.make_batch_iterator(task.dataset(split), max_tokens=max_tokens,
                                        max_sentences=None if max_tokens else MLM_BATCH))


def mlm_train_one(torch, label: str, argv, enc_layers: int, n_valid: int, kernels):
    """One cli.train run, the counts zeroed before and read after: K1 the
    encoder's layers a validation batch (a training micro-batch runs the
    plain path: attention dropout 0.1, as in JAX). -> (launches, record)."""
    from chimera_st_tpu_torch.cli import train

    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_microbatches() as micro, counted_decoder_steps() as steps:
        out = train.main(argv)
    torch.cuda.synchronize()
    c = {fn.__name__: fn.launches for fn in kernels}
    t = out["times"]
    implied = {"encoder_attention": enc_layers * n_valid * len(t["valid_s"]), "conv_tail": 0,
               "decode_attention": 0, "logmel": 0}
    timed = t["update_s"][1:]
    updates = out["trainer"].num_updates - t["restored"]["step"]
    rec = dict(updates=updates, micro_batches=micro[0], step=out["trainer"].num_updates,
               updates_per_s_after_first=len(timed) / sum(timed) if timed else None,
               update_s=t["update_s"], valid=t["valid"], valid_s=t["valid_s"],
               save_s=t["save_s"], load_s=t["load_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               wall_s=time.perf_counter() - t0, launches=c,
               params_m=sum(q.numel() for q in out["trainer"].model.parameters()) / 1e6)
    log(f"  {label}: {rec['params_m']:.1f} M parameters, step {t['restored']['step']} -> "
        f"{rec['step']} ({micro[0]} micro-batches) in {rec['wall_s']:.1f} s, updates/s after the "
        f"first {rec['updates_per_s_after_first']}, peak {rec['peak_memory_gb']:.2f} GB, load "
        f"{t['load_s']:.2f} s, saves {[round(s, 2) for s in t['save_s']]} s, validation "
        f"{t['valid']}; launches {c}")
    if (c != implied or not updates or steps[0]
            or any(not np.isfinite(v) for v in t["valid"])):
        raise AssertionError(f"{label}: launches {c} (want {implied}), {updates} updates")
    return c, rec


def mlm_step_parity(torch, fx):
    """One fp32 update of roberta_base at MLM_PARITY_LAYERS of 12 layers
    (widths kept), card vs CPU, every dropout 0, a micro-batch of 2 blocks
    of up to 512 tokens: compare_step's gates."""
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    task = setup_task({"_name": "masked_lm", "data": str(fx["mlm"])})
    task.load_dataset("valid")
    batch = next(iter(task.make_batch_iterator(task.dataset("valid"), max_sentences=2)
                      .next_epoch_itr(shuffle=False)))
    cfg = {"arch": "roberta_base", "layers": MLM_PARITY_LAYERS, "dropout": 0.0}
    weights = init_params_(task.build_model(dict(cfg), device="cpu", train=True),
                           torch.Generator().manual_seed(12)).state_dict()
    out = {}
    for device in ("cuda", "cpu"):
        model = task.build_model(dict(cfg), device=device, train=True)
        model.load_state_dict(weights)
        step = TrainStep(model, task.build_criterion({"_name": "masked_lm"}),
                         build_optimizer(TRAIN_ADAM, model.parameters()),
                         build_lr_schedule({"_name": "fixed", "lr": 1e-4}),
                         compute_dtype=torch.float32)
        before = {k: q.detach().cpu().clone() for k, q in model.named_parameters()}
        t0 = time.perf_counter()
        metrics = step([batch])
        out[device] = (metrics, before, {k: q.grad.cpu() for k, q in model.named_parameters()},
                       {k: q.detach().cpu() for k, q in model.named_parameters()})
        log(f"  mlm_train fp32 step {device}: {time.perf_counter() - t0:.2f} s, loss "
            f"{metrics['loss']:.4f}, gnorm {metrics['gnorm']:.4f}")
        del model, step
    (mg, before, gg, pg), (mc, _, gc, pc) = out["cuda"], out["cpu"]
    return compare_step(torch, f"mlm_train fp32 step (roberta_base, {MLM_PARITY_LAYERS} layers)",
                        (mg, gg, pg), (mc, gc, pc), before, keys=("loss", "nll_loss"))


def phase_mlm_train(torch, fx, kernels):
    """cli.train --task masked_lm --arch roberta_base with fairseq's README
    flags (MLM_README): run A one epoch (its validation, K1 12 a batch, and
    a save), run B resumed for one more; one fp32 update card vs CPU at 2
    layers; then one or two updates each of legacy_masked_lm (bert_base,
    with its next-sentence head), cross_lingual_lm (xlm_base over the en /
    fr folders), translation_from_pretrained_xlm initialised from that XLM
    checkpoint (its embeddings too: the dictionaries agree) and served by one
    cli.generate batch (K1 6, K3 6 a decoder step), and
    semisupervised_translation (transformer, word-noised denoising pairs
    beside the parallel ones). Prints {"mlm_train": {...}}; returns the
    launches."""
    from chimera_st_tpu_torch.cli import generate

    root = fx["root"]
    counts, rec = {}, {}
    n_valid = mlm_batches(fx["mlm"], {"_name": "masked_lm"}, "valid")
    log(f"mlm_train: cli.train --task masked_lm --arch roberta_base, fairseq's README flags "
        f"(--update-freq 16 -> 1, --warmup-updates 10000 -> 1); {n_valid} validation batch(es)")
    base = [str(fx["mlm"]), "--task", "masked_lm", "--arch", "roberta_base", "--criterion",
            "masked_lm", *MLM_README, "--save-dir", str(root / "roberta_base")]
    for run, epochs in (("A", 1), ("B", 2)):
        counts[f"mlm_train_{run}"], rec[run] = mlm_train_one(
            torch, f"mlm_train roberta_base run {run}", base + ["--max-epoch", str(epochs)], 12,
            n_valid, kernels)
        blocks = MLM_BATCH * MLM_TOKENS_PER_SAMPLE
        rec[run]["tokens_per_s_after_first_at_most"] = (
            blocks * rec[run]["updates_per_s_after_first"]
            if rec[run]["updates_per_s_after_first"] else None)
    if rec["B"]["step"] <= rec["A"]["step"] or rec["B"]["load_s"] <= 0:
        raise AssertionError(f"mlm_train: run B did not resume run A: {rec['A']} {rec['B']}")
    rec["parity"] = mlm_step_parity(torch, fx)
    others = {
        "legacy_masked_lm": ([str(fx["mlm"]), "--task", "legacy_masked_lm", "--arch",
                              "bert_base", "--criterion", "legacy_masked_lm"], 12,
                             mlm_batches(fx["mlm"], {"_name": "legacy_masked_lm"}, "valid")),
        "cross_lingual_lm": ([str(fx["xlm"]), "--task", "cross_lingual_lm",
                              "--monolingual-langs", "en,fr", "--arch", MLM_XLM["arch"],
                              "--criterion", "masked_lm"], 6,
                             mlm_batches(fx["xlm"], {"_name": "cross_lingual_lm",
                                                     "monolingual_langs": "en,fr"}, "valid")),
    }
    for name, (argv, layers, nv) in others.items():
        # the XLM checkpoint warm-starts the translation model below: its
        # parameters are saved, the legacy model's nothing
        save = (["--no-save-optimizer-state"] if name == "cross_lingual_lm" else ["--no-save"])
        counts[f"mlm_{name}"], rec[name] = mlm_train_one(
            torch, f"mlm_train {name}", [*argv, *MLM_README, "--max-update", "2", *save,
                                         "--save-dir", str(root / name)], layers, nv, kernels)
    mt_task = {"_name": "translation_from_pretrained_xlm", "source_lang": "de",
               "target_lang": "en"}
    nv = mlm_batches(fx["mt"], mt_task, "valid", max_tokens=MLM_MT_TOKENS)
    xlm_ckpt = root / "cross_lingual_lm" / "checkpoint_last.ckpt"
    mt_flags = ["--optimizer", "adam", "--adam-betas", "(0.9,0.98)", "--lr", "0.0001",
                "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "1", "--dropout", "0.1",
                "--attention-dropout", "0.1", "--criterion", "label_smoothed_cross_entropy",
                "--label-smoothing", "0.1", "--max-tokens", str(MLM_MT_TOKENS), "--max-update", "2",
                "--dtype", "bfloat16", "--log-interval", "1", "-s", "de", "-t", "en"]
    counts["mlm_xlm_mt"], rec["translation_from_pretrained_xlm"] = mlm_train_one(
        torch, "mlm_train translation_from_pretrained_xlm", [
            str(fx["mt"]), "--task", "translation_from_pretrained_xlm", "--arch",
            "transformer_from_pretrained_xlm", *MLM_MT_WIDTHS, "--pretrained-xlm-checkpoint",
            str(xlm_ckpt), "--init-decoder", "True", *mt_flags, "--no-save-optimizer-state",
            "--save-dir", str(root / "xlm_mt")], 6, nv, kernels)
    (root / "xlm_mt" / "gen").mkdir()
    for fn in kernels:
        fn.launches = 0
    with counted_decoder_steps() as steps:
        t0 = time.perf_counter()
        stats = generate.main([str(fx["mt"]), "--task", "translation_from_pretrained_xlm", "-s",
                               "de", "-t", "en", "--path",
                               str(root / "xlm_mt" / "checkpoint_last.ckpt"), "--gen-subset",
                               "test", "--batch-size", str(MLM_MT_PAIRS["test"]), *MLM_DECODE,
                               "--dtype", "bfloat16", "--scoring", "bleu", "--results-path",
                               str(root / "xlm_mt" / "gen")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c = {fn.__name__: fn.launches for fn in kernels}
    want = {"encoder_attention": 6, "conv_tail": 0, "decode_attention": 6 * steps[0],
            "logmel": 0}
    rec["xlm_decode"] = dict(sentences=stats["sentences"], decoder_steps=steps[0], wall_s=wall,
                             decode_s=stats["decode_s"], launches=c)
    log(f"  xlm_mt cli.generate beam 5: {stats['sentences']} sentences, {steps[0]} decoder steps "
        f"in {stats['decode_s']:.2f} s; launches {c}")
    if c != want or stats["sentences"] != MLM_MT_PAIRS["test"] or steps[1] != 6 * steps[0]:
        raise AssertionError(f"mlm_train xlm decode: launches {c} (want {want})")
    counts["mlm_xlm_decode"] = c
    semi = {"_name": "semisupervised_translation", "source_lang": "de", "target_lang": "en"}
    counts["mlm_semisupervised"], rec["semisupervised_translation"] = mlm_train_one(
        torch, "mlm_train semisupervised_translation", [
            str(fx["mt"]), "--task", "semisupervised_translation", "--arch", "transformer",
            "--lambda-denoising", "1.0", "--word-dropout", "0.1", "--word-shuffle", "3",
            *mt_flags, "--no-save"], 6,
        mlm_batches(fx["mt"], semi, "valid", max_tokens=MLM_MT_TOKENS), kernels)
    print(json.dumps({"mlm_train": rec}), flush=True)
    return counts


def phase_mlm_shapes(torch, ops, seen, records):
    """K1 and K3 at every shape the masked-LM phases launched, against the
    plain versions in bf16 and fp32; timed: K1 at the hub's B 16 / T 512 /
    H 16 / D 64 (with SDPA) and K3 at the XLM decode's."""
    hub_shape = (MLM_BATCH, 512, 16, 64)
    k1, k3 = seen["encoder_attention"], seen["decode_attention"]
    timed = {"encoder_attention": [p for p in k1 if p[0] == hub_shape][:1],
             "conv_tail": [], "decode_attention": [p for p in k3 if p[0][3] == 128][:1]}
    rest = {k: [p for p in v if p not in timed[k]] for k, v in seen.items()}
    phase_shapes(torch, ops, timed, records, "mlm", lambda sh: (
        sh["encoder_attention"] == [hub_shape] and len(sh["decode_attention"]) == 1
        and not sh["conv_tail"]), timed=("encoder_attention", "decode_attention"))
    phase_shapes(torch, ops, rest, records, "mlm_all", lambda sh: (
        {(H, D) for _, _, H, D in sh["encoder_attention"]} >= {(16, 64), (12, 64), (8, 128)}))


# ---- K1 / K3 at head dim 80 (the xlm preset) and the convolutional and
# recurrent zoo

XLM_SERVE = {"arch": "xlm", "dropout": 0.1}  # 16 x 1,280, FFN 5,120, 16 heads of 80
XLM_SERVE_LAYERS = 16
XLM_HEADS = 16
XLM_MT_DEPTH = 2  # the XLM-initialised model's encoder and decoder layers, cut from 16
XLM_MT = {"arch": "transformer_from_pretrained_xlm", "encoder_embed_dim": 1280,
          "encoder_ffn_dim": 5120, "encoder_heads": 16, "encoder_layers": XLM_MT_DEPTH,
          "decoder_embed_dim": 1280, "decoder_ffn_dim": 5120, "decoder_heads": 16,
          "decoder_layers": XLM_MT_DEPTH, "activation": "gelu"}
ZOO_DUMMY_MT_ENCODER_LAYERS = 6  # transformer's: K1 in each a micro-batch


def phase_xlm_serve(torch, fx, kernels):
    """Repair C2 on its path: the ``xlm`` preset (16 x 1,280, FFN 5,120, 16
    heads of 80) over the masked-LM fixture's dictionary, bf16 through the
    RoBERTa hub from a native .ckpt: extract_features over the fixture's
    MLM_SERVE_BATCHES batches of 16 rows of 64-512 tokens (K1 at D 80, 16 a
    batch); then a transformer_from_pretrained_xlm model at the xlm widths,
    XLM_MT_DEPTH + XLM_MT_DEPTH layers, initialised from that checkpoint by
    the task's warm start and decoded by one cli.generate batch of 16 at
    beam 5 (K1 at D 80 in the encoder, K3 at H 16 / D 80 in every decoder
    step). The counts are zeroed before each and exact after. First the fp32
    card-vs-CPU hub at 2 of 16 layers. Prints {"xlm_serve": {...}}; returns
    the launches."""
    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.cli import generate
    from chimera_st_tpu_torch.cli.generate import load_model_and_params
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.tasks import setup_task

    rec = {"parity": mlm_hub_parity(torch, fx, XLM_SERVE, "xlm_serve")}
    ckpt = mlm_checkpoint(torch, fx, "xlm", XLM_SERVE, 17)
    task = mlm_task(fx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_model_and_params(str(ckpt), task, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    rec["load_s"] = time.perf_counter() - t0
    hub = mlm_hub(fx, task, model)
    hub.extract_features(fx["serve"][0])  # warm-up
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [hub.extract_features(b) for b in fx["serve"]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"xlm_serve_features": {k.__name__: k.launches for k in kernels}}
    want = {"encoder_attention": XLM_SERVE_LAYERS * MLM_SERVE_BATCHES, "conv_tail": 0,
            "decode_attention": 0, "logmel": 0}
    if counts["xlm_serve_features"] != want:
        raise AssertionError(f"xlm_serve: launches {counts['xlm_serve_features']} (want {want})")
    width = model.cfg.embed_dim
    if any(f.shape != (MLM_BATCH, 512, width) or not np.isfinite(f).all() for f in feats):
        raise AssertionError(f"xlm_serve: features not finite [16, 512, {width}]")
    n_tokens = sum(int((b != 1).sum()) for b in fx["serve"])
    rec["features"] = dict(sequences=MLM_BATCH * MLM_SERVE_BATCHES, tokens=n_tokens, wall_s=wall,
                           sequences_per_s=MLM_BATCH * MLM_SERVE_BATCHES / wall,
                           tokens_per_s=n_tokens / wall,
                           peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"xlm_serve bf16 xlm (16 heads of 80): load {rec['load_s']:.2f} s; features "
        f"{rec['features']['sequences_per_s']:.1f} sequences/s, "
        f"{rec['features']['tokens_per_s']:.0f} tokens/s; peak "
        f"{rec['features']['peak_memory_gb']:.2f} GB; launches {counts['xlm_serve_features']}")
    del hub, model
    torch.cuda.empty_cache()

    root = fx["root"]
    mt_cfg = {"_name": "translation_from_pretrained_xlm", "data": str(fx["mt"]),
              "source_lang": "de", "target_lang": "en", "pretrained_xlm_checkpoint": str(ckpt),
              "init_decoder": True}
    mt_task = setup_task(dict(mt_cfg))
    t0 = time.perf_counter()
    mt = init_params_(mt_task.build_model(dict(XLM_MT), device="cuda", train=True),
                      torch.Generator(device="cuda").manual_seed(18))
    mt_task.post_init_params(mt)
    mt_ckpt = root / "xlm_mt.ckpt"
    save_model(str(mt_ckpt), mt, XLM_MT)
    del mt
    torch.cuda.empty_cache()
    log(f"  xlm_mt: {XLM_MT_DEPTH} + {XLM_MT_DEPTH} layers at the xlm widths, initialised from "
        f"the xlm checkpoint and written in {time.perf_counter() - t0:.1f} s")
    (root / "xlm_gen").mkdir()
    for k in kernels:
        k.launches = 0
    with counted_decoder_steps() as steps:
        t0 = time.perf_counter()
        stats = generate.main([str(fx["mt"]), "--task", "translation_from_pretrained_xlm", "-s",
                               "de", "-t", "en", "--path", str(mt_ckpt), "--gen-subset", "test",
                               "--batch-size", str(MLM_MT_PAIRS["test"]), *MLM_DECODE, "--dtype",
                               "bfloat16", "--scoring", "bleu", "--results-path",
                               str(root / "xlm_gen")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c = {k.__name__: k.launches for k in kernels}
    want = {"encoder_attention": XLM_MT_DEPTH, "conv_tail": 0,
            "decode_attention": XLM_MT_DEPTH * steps[0], "logmel": 0}
    rec["decode"] = dict(sentences=stats["sentences"], decoder_steps=steps[0], wall_s=wall,
                         decode_s=stats["decode_s"], launches=c)
    log(f"  xlm_mt cli.generate beam 5: {stats['sentences']} sentences, {steps[0]} decoder steps "
        f"in {stats['decode_s']:.2f} s; launches {c}")
    if c != want or stats["sentences"] != MLM_MT_PAIRS["test"]:
        raise AssertionError(f"xlm_serve decode: launches {c} (want {want})")
    counts["xlm_serve_decode"] = c
    ckpt.unlink()
    mt_ckpt.unlink()
    print(json.dumps({"xlm_serve": rec}), flush=True)
    return counts


def phase_xlm_shapes(torch, ops, seen, records):
    """K1 and K3 at every shape xlm_serve launched (head dim 80), against the
    plain versions in bf16 and fp32, K3 at steps 0, 31 and 63 with the
    cache writes bit-equal; timed: K1 at the hub's B 16 / T 512 / H 16 / D 80
    (with SDPA) and K3 at the decode's S 16 x C 5, H 16, D 80."""
    hub_shape = (MLM_BATCH, 512, XLM_HEADS, 80)
    k1 = seen["encoder_attention"]
    timed = {"encoder_attention": [p for p in k1 if p[0] == hub_shape][:1], "conv_tail": [],
             "decode_attention": seen["decode_attention"][:1]}
    rest = {k: [p for p in v if p not in timed[k]] for k, v in seen.items()}
    phase_shapes(torch, ops, timed, records, "xlm", lambda sh: (
        sh["encoder_attention"] == [hub_shape] and len(sh["decode_attention"]) == 1
        and sh["decode_attention"][0][3] == 80), timed=("encoder_attention", "decode_attention"))
    phase_shapes(torch, ops, rest, records, "xlm_all", lambda sh: (
        {D for _, _, _, D in sh["encoder_attention"]} == {80} and not sh["conv_tail"]))


def phase_zoo_shapes(torch, ops, seen, records):
    """K1 at every shape the zoo phases launched (dummy_mt's encoder: micro-
    batches of 64 sentences at 8 heads of 64), against the plain version in
    bf16 and fp32; the zoo launches no K2 or K3 (berard's K4 input is held
    in zoo_steps)."""
    phase_shapes(torch, ops, seen, records, "zoo", lambda sh: (
        {(B, H, D) for B, _, H, D in sh["encoder_attention"]} == {(64, 8, 64)}
        and not sh["conv_tail"] and not sh["decode_attention"]))


# the zoo's language models, at their presets, on the family's LM stream
ZOO_LMS = {"fconv_lm": ["--arch", "fconv_lm_dauphin_wikitext103"],
           "lightconv_lm_gbw": ["--arch", "lightconv_lm_gbw"],
           "dynamicconv_lm": ["--arch", "dynamicconv_lm"], "lstm_lm": ["--arch", "lstm_lm"]}
ZOO_LM_UPDATES = 2
ZOO_LM_RESUMED = "lstm_lm"  # resumed from its save for one update more


def zoo_counts(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


def zoo_train_run(torch, label: str, argv, kernels, tokens_per_update=None, want=None):
    """One cli.train run, the counts zeroed before and read after (``want``,
    default none of the kernels: the zoo runs no attention the kernels
    cover) -> (launches, record with updates/s after the first, tokens/s and
    peak memory)."""
    from chimera_st_tpu_torch.cli import train

    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_microbatches() as micro:
        out = train.main(argv)
    torch.cuda.synchronize()
    c = zoo_counts(kernels)
    t = out["times"]
    timed = t["update_s"][1:]
    rate = len(timed) / sum(timed) if timed else None
    rec = dict(step=out["trainer"].num_updates, restored=t["restored"]["step"],
               micro_batches=micro[0], updates_per_s_after_first=rate,
               tokens_per_s_after_first=(tokens_per_update * rate
                                         if rate and tokens_per_update else None),
               update_s=t["update_s"], valid=t["valid"], load_s=t["load_s"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               wall_s=time.perf_counter() - t0, launches=c,
               params_m=sum(q.numel() for q in out["trainer"].model.parameters()) / 1e6)
    log(f"  {label}: {rec['params_m']:.1f} M parameters, step {rec['restored']} -> "
        f"{rec['step']} ({micro[0]} micro-batches) in {rec['wall_s']:.1f} s; updates/s after "
        f"the first {rate}, tokens/s {rec['tokens_per_s_after_first']}; peak "
        f"{rec['peak_memory_gb']:.2f} GB; validation {t['valid']}; launches {c}")
    want = want or {"encoder_attention": 0, "conv_tail": 0, "decode_attention": 0, "logmel": 0}
    if c != want or rec["step"] <= rec["restored"] \
            or not all(np.isfinite(v) for v in t["valid"]):
        raise AssertionError(f"{label}: launches {c} (want {want}), {rec}")
    return c, rec


def phase_zoo_lm_train(torch, fx, kernels):
    """cli.train --task language_modeling of the zoo's LMs (ZOO_LMS, at
    their presets' widths and depths) on the family's seeded LM stream of a
    32,768-subword dictionary (--vocab-size: the JAX builders read no task
    vocabulary, ROADMAP C3): blocks of LM_BLOCK tokens, 8 a micro-batch,
    bf16, ZOO_LM_UPDATES updates each with validation; lstm_lm resumed from
    its save for one more; cli.validate of its checkpoint. No kernel runs (no
    self-attention). Prints {"zoo_lm_train": {...}}; returns the launches."""
    import shutil

    from chimera_st_tpu_torch.cli import validate
    from chimera_st_tpu_torch.data.dictionary import Dictionary

    vocab = len(Dictionary.load(str(fx["lm"] / "dict.txt")))
    counts, rec = {}, {}
    common = ["--task", "language_modeling", "--criterion", "cross_entropy",
              "--vocab-size", str(vocab), "--tokens-per-sample", str(LM_BLOCK), "--optimizer",
              "adam", "--adam-betas", "(0.9, 0.98)", "--lr", "5e-4", "--max-tokens",
              str(8 * LM_BLOCK), "--dtype", "bfloat16", "--train-subset", "test",
              "--valid-subset", "valid", "--no-epoch-checkpoints", "--log-interval", "1"]
    log(f"zoo_lm_train: cli.train --task language_modeling, {vocab}-row dictionary, "
        f"{ZOO_LM_UPDATES} updates of 8 blocks of {LM_BLOCK} tokens each")
    for name, model_argv in ZOO_LMS.items():
        arch = model_argv[1]
        save = fx["root"] / f"zoo_{name}"
        argv = [str(fx["lm"]), *model_argv, *common, "--save-dir", str(save)]
        counts[f"zoo_lm_{name}"], rec[name] = zoo_train_run(
            torch, f"zoo_lm_train {arch}", argv + ["--max-update", str(ZOO_LM_UPDATES)],
            kernels, 8 * LM_BLOCK)
        if name == ZOO_LM_RESUMED:
            counts[f"zoo_lm_{name}_resumed"], rec[f"{name}_resumed"] = zoo_train_run(
                torch, f"zoo_lm_train {arch} resumed", argv + [
                    "--max-update", str(ZOO_LM_UPDATES + 1)], kernels, 8 * LM_BLOCK)
            if rec[f"{name}_resumed"]["restored"] != ZOO_LM_UPDATES:
                raise AssertionError(f"zoo_lm_train: the resume started at "
                                     f"{rec[f'{name}_resumed']['restored']}")
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            stats = validate.main([str(fx["lm"]), "--task", "language_modeling", "--path",
                                   str(save / "checkpoint_last.ckpt"), "--valid-subset", "valid",
                                   "--criterion", "cross_entropy", "--tokens-per-sample",
                                   str(LM_BLOCK), "--batch-size", "8", "--dtype", "bfloat16"])
            torch.cuda.synchronize()
            rec["validate"] = dict(wall_s=time.perf_counter() - t0, **stats)
            counts["zoo_lm_validate"] = zoo_counts(kernels)
            log(f"  cli.validate {arch}: {stats} in {rec['validate']['wall_s']:.1f} s")
            if any(counts["zoo_lm_validate"].values()) or not all(
                    np.isfinite(v) for v in stats.values()):
                raise AssertionError(f"zoo_lm_train validate: {stats}, "
                                     f"{counts['zoo_lm_validate']}")
        shutil.rmtree(save)
    print(json.dumps({"zoo_lm_train": rec}), flush=True)
    return counts


# the encoder-decoder zoo at fairseq's presets; one bf16 TrainStep update
# each (the JAX train CLI cannot initialise them, ROADMAP C3)
ZOO_STEPS = {arch: {"arch": arch} for arch in (
    "fconv_wmt_en_de", "fconv_self_att", "lightconv_wmt_en_de_big", "dynamicconv_iwslt_de_en",
    "lstm_luong_wmt_en_de")}
ZOO_DUMMY_MODEL = {"arch": "dummy_model"}  # 24 x 1,024
ZOO_BERARD = {"arch": "s2t_berard_512_5_3", "tgt_vocab_size": 10000, "compute_fbank": True}
ZOO_BERARD_WAVS = 8  # of 2-6 s
ZOO_PARITY = {"arch": "lstm_luong_wmt_en_de", "encoder_layers": 1, "decoder_layers": 1}


def restack_ms(torch, model):
    """Device ms of what keeping each gate layer as a parameter of its own
    costs an update of ``model``: every recurrence's ``flat_weights()`` (the
    ``torch.cat`` of its gate layers) cast to bf16, as each forward of
    models/lstm.py builds them, and the backward of that, once for each
    recurrence (an update runs each once). None without a recurrence."""
    from chimera_st_tpu_torch.models.lstm import _Recurrence

    rnns = [m for m in model.modules() if isinstance(m, _Recurrence)]
    if not rnns:
        return None
    grads = [torch.ones_like(w, dtype=torch.bfloat16)
             for m in rnns for w in m.flat_weights() if w.requires_grad]

    def restack():
        ws = [w.to(torch.bfloat16) for m in rnns for w in m.flat_weights() if w.requires_grad]
        torch.autograd.backward(ws, grads)

    ms = cuda_ms(restack, reps=5)
    model.zero_grad(set_to_none=True)
    return ms


def zoo_step_time(torch, label: str, model, criterion, batch, kernels, want):
    """Two bf16 TrainStep updates of ``model`` on ``batch`` (the first warms
    up); the second timed, the counts of both exact -> record (with
    ``restack_ms`` where the model has recurrences)."""
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.train import TrainStep

    step = TrainStep(model, criterion, build_optimizer(TRAIN_ADAM, list(model.parameters())),
                     build_lr_schedule({"_name": "fixed", "lr": 1e-4}),
                     compute_dtype=torch.bfloat16)
    step([batch])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = step([batch])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    c = zoo_counts(kernels)
    rec = dict(update_ms=ms, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss=metrics["loss"], gnorm=metrics["gnorm"], launches=c,
               params_m=sum(q.numel() for q in model.parameters()) / 1e6)
    log(f"  zoo_steps {label}: {rec['params_m']:.1f} M parameters, {ms:.1f} ms an update, peak "
        f"{rec['peak_memory_gb']:.2f} GB, loss {metrics['loss']:.3f}, gnorm "
        f"{metrics['gnorm']:.3f}; launches {c}")
    rec["restack_ms"] = restack_ms(torch, model)
    if rec["restack_ms"] is not None:
        log(f"  zoo_steps {label}: the recurrences' weights restacked and cast, forward and "
            f"backward: {rec['restack_ms']:.3f} ms of the update's {ms:.1f}")
    if c != want or not (np.isfinite(metrics["loss"]) and np.isfinite(metrics["gnorm"])):
        raise AssertionError(f"zoo_steps {label}: launches {c} (want {want}), {metrics}")
    return c, rec


def phase_zoo_steps(torch, fx, kernels, records):
    """One bf16 TrainStep update at full width of each encoder-decoder of
    ZOO_STEPS on a family MT batch (en -> de, the 32,768-subword dictionary,
    up to 4,096 tokens), of s2t_berard_512_5_3 on ZOO_BERARD_WAVS seeded
    wavs through the port's compute_fbank (K4 once an update; K4 first held
    against its plain version on that batch, into the K4 record's
    ``shapes``), and of
    dummy_model (24 x 1,024) on a dummy_lm batch; ms an update and peak
    memory each, the counts exact (no K1 / K3: the zoo's attention is
    cross-attention or causal, run plainly). Then one fp32 update of
    lstm_luong_wmt_en_de at 1 + 1 layers, card vs CPU within compare_step's
    gates. Prints {"zoo_steps": {...}}; returns the launches."""
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train.train_step import prepare_batch

    none = {"encoder_attention": 0, "conv_tail": 0, "decode_attention": 0, "logmel": 0}
    task = setup_task({"_name": "translation", "data": str(fx["mt"]), "source_lang": "en",
                       "target_lang": "de"})
    task.load_dataset("test")
    batch = prepare_batch(next(iter(task.make_batch_iterator(
        task.dataset("test"), max_tokens=MT_MAX_TOKENS).next_epoch_itr(shuffle=False))), "cuda")
    crit = task.build_criterion({"_name": "label_smoothed_cross_entropy",
                                 "label_smoothing": 0.1})
    counts, rec = {}, {"batch": dict(sentences=int(batch["target"].shape[0]),
                                     tokens=float(batch["ntokens"]))}
    for i, (arch, model_cfg) in enumerate(ZOO_STEPS.items()):
        model = init_params_(task.build_model(dict(model_cfg), device="cuda", train=True),
                             torch.Generator(device="cuda").manual_seed(40 + i))
        counts[f"zoo_step_{arch}"], rec[arch] = zoo_step_time(torch, arch, model, crit, batch,
                                                              kernels, none)
        del model
        torch.cuda.empty_cache()

    from chimera_st_tpu_torch.config.registry import ARCHITECTURES
    from chimera_st_tpu_torch.criterions.label_smoothed_ce import make_label_smoothed_ce
    from chimera_st_tpu_torch.models.berard import build_berard
    from chimera_st_tpu_torch.ops import logmel as lm
    from chimera_st_tpu_torch.ops.fbank import num_frames

    rng = np.random.default_rng(41)
    wav, mask = make_audio(rng, ZOO_BERARD_WAVS, 2.0, 6.0)
    prev = rng.integers(4, ZOO_BERARD["tgt_vocab_size"], size=(ZOO_BERARD_WAVS, 30))
    prev[:, 0] = 2
    target = np.concatenate([prev[:, 1:], np.full((ZOO_BERARD_WAVS, 1), 2)], axis=1)
    audio_batch = prepare_batch({"audio": wav, "audio_padding_mask": mask,
                                 "prev_output_tokens": prev, "target": target,
                                 "ntokens": float(target.size)}, "cuda")
    B, T = wav.shape
    label = f"zoo_berard_B{B}_T{T}"
    _, _, err, exact_err = k4_check(torch, lm, audio_batch["audio"].float().contiguous(), label,
                                    num_frames(T))
    next(r for r in records if r["name"] == "logmel").setdefault("shapes", {})[label] = dict(
        max_abs_err=err, max_abs_err_fp64_plain=exact_err)
    berard_cfg = ARCHITECTURES.get(ZOO_BERARD["arch"])[1](dict(ZOO_BERARD))
    model = init_params_(build_berard(berard_cfg, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(46)).train()
    counts["zoo_step_s2t_berard"], rec["s2t_berard_512_5_3"] = zoo_step_time(
        torch, "s2t_berard_512_5_3 (K4 features)", model,
        make_label_smoothed_ce({"label_smoothing": 0.1}), audio_batch, kernels,
        dict(none, logmel=1))
    rec["s2t_berard_512_5_3"]["audio_s"] = float((~mask).sum()) / 16000
    del model
    torch.cuda.empty_cache()

    lm_task = setup_task({"_name": "dummy_lm", "data": "", "dict_size": 49996,
                          "tokens_per_sample": 512, "dataset_size": 8})
    lm_task.load_dataset("train")
    lm_batch = prepare_batch(next(iter(lm_task.make_batch_iterator(
        lm_task.dataset("train"), max_sentences=8).next_epoch_itr(shuffle=False))), "cuda")
    model = init_params_(lm_task.build_model(dict(ZOO_DUMMY_MODEL), device="cuda", train=True),
                         torch.Generator(device="cuda").manual_seed(47))
    counts["zoo_step_dummy_model"], rec["dummy_model"] = zoo_step_time(
        torch, "dummy_model (dummy_lm batch of 8 x 512)", model,
        lm_task.build_criterion({"_name": "cross_entropy"}), lm_batch, kernels, none)
    del model
    torch.cuda.empty_cache()

    micro = [next(iter(task.make_batch_iterator(task.dataset("test"), max_sentences=2)
                       .next_epoch_itr(shuffle=False)))]
    rec["parity"] = family_step_parity(torch, "zoo_steps fp32 lstm_luong_wmt_en_de (1 + 1 layers)",
                                       task, ZOO_PARITY, {"_name": "label_smoothed_cross_entropy",
                                                          "label_smoothing": 0.1}, micro)
    print(json.dumps({"zoo_steps": rec}), flush=True)
    return counts


ZOO_TASK_UPDATES = 3
ZOO_TASK_ARCHS = {"dummy_mt": ["--arch", "transformer"], "dummy_lm": ["--arch", "transformer_lm"],
                  "dummy_masked_lm": ["--arch", "roberta_base"],
                  "simple_classification": ["--arch", "rnn_classifier"]}


def make_classification_fixture(root: Path, seed: int = 101) -> Path:
    """simple_classification data: 64 sentences of a 2,000-word
    vocabulary, two labels."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    (root / "dict.input.txt").write_text("".join(f"w{i} {2000 - i}\n" for i in range(2000)))
    (root / "dict.label.txt").write_text("pos 1\nneg 1\n")
    for split, n in (("train", 64), ("valid", 16)):
        rows = [" ".join(f"w{i}" for i in rng.integers(0, 2000, size=int(rng.integers(5, 60))))
                for _ in range(n)]
        (root / f"{split}.input").write_text("\n".join(rows) + "\n")
        (root / f"{split}.label").write_text("\n".join(rng.choice(["pos", "neg"], n)) + "\n")
    return root


def phase_zoo_tasks(torch, work: Path, kernels):
    """fairseq's benchmark tasks (fixed synthetic batches) and the tutorial
    classification through cli.train, ZOO_TASK_UPDATES updates each, bf16,
    no validation: dummy_mt with transformer (K1 6 a micro-batch: its
    attention dropout is 0), dummy_lm with transformer_lm (causal: none;
    the JAX CLI cannot initialise dummy_model, ROADMAP C3, which zoo_steps
    steps instead), dummy_masked_lm with roberta_base (attention dropout
    0.1: the plain path) and simple_classification with rnn_classifier.
    Prints {"zoo_tasks": {...}}; returns the launches."""
    common = ["--optimizer", "adam", "--lr", "1e-4", "--dtype", "bfloat16",
              "--max-update", str(ZOO_TASK_UPDATES), "--disable-validation", "--no-save",
              "--log-interval", "1"]
    dummy = ["--dict-size", "49996", "--dataset-size", "256"]
    runs = {
        "dummy_mt": ([str(work), "--task", "dummy_mt", *ZOO_TASK_ARCHS["dummy_mt"], *dummy,
                      "--src-len", "30", "--tgt-len", "30", "--max-sentences", "64",
                      "--criterion", "label_smoothed_cross_entropy"], 64 * 30,
                     ZOO_DUMMY_MT_ENCODER_LAYERS),
        "dummy_lm": ([str(work), "--task", "dummy_lm", *ZOO_TASK_ARCHS["dummy_lm"], *dummy,
                      "--tokens-per-sample", "512", "--max-sentences", "8",
                      "--criterion", "cross_entropy"], 8 * 512, 0),
        "dummy_masked_lm": ([str(work), "--task", "dummy_masked_lm",
                             *ZOO_TASK_ARCHS["dummy_masked_lm"],
                             "--dict-size", "49995", "--dataset-size", "256",
                             "--tokens-per-sample", "512", "--max-sentences", "8",
                             "--criterion", "masked_lm"], 8 * 512, 0),
        "simple_classification": ([str(make_classification_fixture(work / "cls")), "--task",
                                   "simple_classification",
                                   *ZOO_TASK_ARCHS["simple_classification"],
                                   "--max-sentences", "32", "--criterion",
                                   "simple_classification"], None, 0),
    }
    counts, rec = {}, {}
    for name, (argv, tokens, k1_per_micro) in runs.items():
        want = None
        if k1_per_micro:
            want = {"encoder_attention": k1_per_micro * ZOO_TASK_UPDATES, "conv_tail": 0,
                    "decode_attention": 0, "logmel": 0}
        counts[f"zoo_task_{name}"], rec[name] = zoo_train_run(
            torch, f"zoo_tasks {name}", [*argv, *common, "--save-dir", str(work / name)],
            kernels, tokens, want)
    print(json.dumps({"zoo_tasks": rec}), flush=True)
    return counts


# ---- this slice: the untied output projection (C4), GPT-2, the stacked
# pipeline LM, quantization and a world of one over NCCL

UNTIED_S2T_WAVS = 4
GPT2_BLOCK = 1024  # the presets' n_positions
GPT2_UPDATES = 2
GPT2_XL_BATCH = 2  # cut only if the update does not fit; the widths never are


def zeroed(kernels):
    for fn in kernels:
        fn.launches = 0


def launches(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


@contextlib.contextmanager
def recorded_updates():
    """While open, notes the (loss, gnorm) of every update the trainer
    records (the train CLI's logged values)."""
    from chimera_st_tpu_torch.train.trainer import Trainer

    seen, record = [], Trainer._record_update

    def noted(self, m, num_updates):
        seen.append((float(m["loss"]), float(m["gnorm"])))
        return record(self, m, num_updates)

    Trainer._record_update = noted
    try:
        yield seen
    finally:
        Trainer._record_update = record


def phase_untied(torch, fx, work: Path, kernels, records):
    """C4: a fairseq ``.pt`` of the flagship (the CLI fixture's weights)
    with an ``output_projection`` of its own and
    ``share_decoder_input_output_embed=False`` in its args: ``cli.generate``
    fp32 on the card vs ``--device cpu`` on the fixture's 4 ``pairs`` wavs
    (hypotheses identical), then bf16 on the card with the counts zeroed (K1
    24 and K2 6 a batch, K3 6 a decode step). Then an untied
    ``s2t_transformer_s`` (``compute_fbank``, seeded) on UNTIED_S2T_WAVS
    seeded wavs: K4 held against its plain version on the batch, fp32 card
    vs CPU beam 5 (tokens identical), bf16 on the card with the counts
    exact (K4 1, K1 12, K3 6 a decode step). Returns the launches; prints
    {"untied": {...}}."""
    import dataclasses

    from chimera_st_tpu_torch.generation.generator import GeneratorSettings, SequenceGenerator
    from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel
    from chimera_st_tpu_torch.models.s2t_transformer import build_s2t_transformer
    from chimera_st_tpu_torch.ops import logmel as lm
    from chimera_st_tpu_torch.ops.fbank import num_frames

    t_phase = time.perf_counter()
    base = fx["model"]
    cfg = dataclasses.replace(base.cfg, share_decoder_input_output_embed=False)
    untied = ChimeraInterlinguaModel(cfg, device="cpu")
    V, D = cfg.tgt_vocab_size, cfg.decoder_embed_dim
    proj = torch.randn(V, D, generator=torch.Generator().manual_seed(61)) * D ** -0.5
    untied.load_state_dict({**base.state_dict(), "decoder.output_projection.weight": proj})
    path = work / "untied.pt"
    torch.save({"args": fixture_args(cfg, fx["conv_feature_layers"]),
                "model": fairseq_state_dict(torch, untied)}, str(path))
    del untied
    rec = {"pt_mb": path.stat().st_size / 1e6}
    common = ["--batch-size", "4", "--dtype", "float32", *PARITY_DECODE]
    gpu_text, _, gpu_s = cli_generate(fx, work / "untied_cuda", "pairs", common, path=path)
    cpu_text, _, cpu_s = cli_generate(fx, work / "untied_cpu", "pairs",
                                      common + ["--device", "cpu"], path=path)
    same_hypotheses("untied flagship .pt: cli.generate fp32 card vs CPU",
                    parse_protocol(gpu_text)[0], parse_protocol(cpu_text)[0], 4)
    zeroed(kernels)
    with counted_decoder_steps() as steps:
        text, stats, wall = cli_generate(fx, work / "untied_bf16", "pairs",
                                         ["--batch-size", "4", "--dtype", "bfloat16"], path=path)
        torch.cuda.synchronize()
    counts = {"untied_flagship": launches(kernels)}
    implied = {"encoder_attention": 24, "conv_tail": 6, "decode_attention": 6 * steps[0],
               "logmel": 0}
    hyps, full, _ = parse_protocol(text)
    if counts["untied_flagship"] != implied or len(full) != 4 or steps[0] == 0:
        raise AssertionError(f"untied flagship: launches {counts['untied_flagship']} "
                             f"(want {implied}), {len(full)} samples")
    rec["flagship"] = dict(fp32_card_s=gpu_s, fp32_cpu_s=cpu_s, bf16_wall_s=wall,
                           bf16_decode_s=stats["decode_s"], decode_steps=steps[0],
                           launches=counts["untied_flagship"])
    log(f"  untied flagship: fp32 card {gpu_s:.1f} s vs CPU {cpu_s:.1f} s, identical; bf16 "
        f"{stats['decode_s']:.2f} s decode, launches {counts['untied_flagship']}")
    path.unlink()

    build = seeded_builder(torch, lambda d: build_s2t_transformer(
        "s2t_transformer_s", {"tgt_vocab_size": 8000, "compute_fbank": True,
                              "share_decoder_input_output_embed": False}, device=d), seed=62)
    wav, mask = make_audio(np.random.default_rng(63), UNTIED_S2T_WAVS, 2.0, 6.0)
    wav_t, mask_t = torch.from_numpy(wav), torch.from_numpy(mask)
    B, T = wav.shape
    label = f"untied_s2t_B{B}_T{T}"
    _, _, err, exact_err = k4_check(torch, lm, wav_t.cuda().contiguous(), label, num_frames(T))
    next(r for r in records if r["name"] == "logmel").setdefault("shapes", {})[label] = dict(
        max_abs_err=err, max_abs_err_fp64_plain=exact_err)
    settings = GeneratorSettings(beam_size=5, max_decode_len=16)
    outs = {}
    for device in ("cuda", "cpu"):
        model = build(device, torch.float32)
        assert hasattr(model.decoder, "output_projection")
        outs[device] = [x.cpu() for x in SequenceGenerator(model, settings).generate_audio(
            wav_t.to(device), mask_t.to(device))]
        del model
    if not torch.equal(outs["cuda"][0], outs["cpu"][0]):
        raise AssertionError("untied s2t_transformer_s: fp32 card and CPU tokens differ")
    check("untied s2t_transformer_s fp32 beam 5: tokens identical; scores card vs CPU",
          max_err(outs["cuda"][1], outs["cpu"][1]), 1e-3)
    model = build("cuda", torch.bfloat16)
    zeroed(kernels)
    with counted_decoder_steps() as steps:
        tokens, scores, _ = SequenceGenerator(model, settings).generate_audio(
            wav_t.cuda(), mask_t.cuda())
        torch.cuda.synchronize()
    counts["untied_s2t"] = launches(kernels)
    implied = {"encoder_attention": 12, "conv_tail": 0, "decode_attention": 6 * steps[0],
               "logmel": 1}
    if counts["untied_s2t"] != implied or not torch.isfinite(scores).all():
        raise AssertionError(f"untied s2t: launches {counts['untied_s2t']} (want {implied})")
    rec["s2t"] = dict(wavs=B, samples=T, decode_steps=steps[0], launches=counts["untied_s2t"],
                      k4_max_abs_err=err)
    del model
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"untied: {rec['phase_s']:.1f} s; launches {counts}")
    print(json.dumps({"untied": rec}), flush=True)
    return counts


def gpt2_state_dict(torch, cfg, seed: int):
    """A GPT-2 state dict under HF's names (``GPT2LMHeadModel``'s, Conv1D
    weights [in, out]) with seeded values at ``init_params_``'s scales,
    made without ``transformers``."""
    from chimera_st_tpu_torch.models.hf_gpt2 import GPT2LM
    from chimera_st_tpu_torch.models.interlingua import init_params_

    model = init_params_(GPT2LM(cfg, device="cpu"), torch.Generator().manual_seed(seed))
    ours = model.state_dict()
    hf = {"transformer.wte.weight": ours["wte.weight"], "transformer.wpe.weight": ours["wpe.weight"],
          "transformer.ln_f.weight": ours["ln_f.weight"], "transformer.ln_f.bias": ours["ln_f.bias"],
          "lm_head.weight": ours["wte.weight"]}
    names = {"ln_1": "ln_1", "ln_2": "ln_2", "c_attn": "attn.c_attn",
             "attn_c_proj": "attn.c_proj", "mlp_c_fc": "mlp.c_fc", "mlp_c_proj": "mlp.c_proj"}
    for i in range(cfg.n_layer):
        for ours_name, hf_name in names.items():
            for leaf in ("weight", "bias"):
                hf[f"transformer.h.{i}.{hf_name}.{leaf}"] = ours[f"h.{i}.{ours_name}.{leaf}"]
    return hf


def phase_gpt2(torch, fx, kernels):
    """GPT-2: ``hf_gpt2`` (12 x 768, 12 heads) at full width and depth,
    GPT2_UPDATES bf16 updates through ``cli.train --task language_modeling``
    on the family's LM stream, GPT2_BLOCK tokens a sample, 8 a micro-batch;
    ``hf_gpt2_xl`` (48 x 1,600, 25 heads, 1.56 B) at full width and depth,
    one bf16 ``TrainStep`` update of GPT2_XL_BATCH x GPT2_BLOCK tokens, its
    peak memory; an HF-named state dict made from a seed at the xl widths
    and 2 layers, imported and run fp32 on the card vs the CPU. GPT-2's
    causal attention is the plain path: no launches, which the phase
    asserts. Returns the launches; prints {"gpt2": {...}}."""
    import itertools

    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.models.hf_gpt2 import (GPT2Config, build_hf_gpt2,
                                                     import_hf_gpt2_state_dict)
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train import TrainStep

    t_phase = time.perf_counter()
    rec = {}
    argv = [str(fx["lm"]), "--task", "language_modeling", "--arch", "hf_gpt2",
            "--criterion", "lm_cross_entropy", "--tokens-per-sample", str(GPT2_BLOCK),
            "--max-tokens", str(8 * GPT2_BLOCK), "--optimizer", "adam", "--adam-betas",
            "(0.9, 0.98)", "--lr", "5e-4", "--lr-scheduler", "inverse_sqrt", "--warmup-updates",
            "4", "--dtype", "bfloat16", "--max-update", str(GPT2_UPDATES), "--train-subset",
            "test", "--disable-validation", "--no-save", "--save-dir",
            str(fx["root"] / "gpt2")]
    zeroed(kernels)
    torch.cuda.reset_peak_memory_stats()
    with recorded_updates() as updates:
        out = train.main(argv)
    torch.cuda.synchronize()
    counts = {"gpt2_train": launches(kernels)}
    n = out["trainer"].num_updates
    rec["hf_gpt2"] = dict(updates=n, update_s=out["times"]["update_s"], losses=updates,
                          params_m=sum(p.numel() for p in out["trainer"].model.parameters()) / 1e6,
                          peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del out
    torch.cuda.empty_cache()
    log(f"  hf_gpt2 cli.train: {n} updates of 8 x {GPT2_BLOCK} tokens, "
        f"{rec['hf_gpt2']['params_m']:.1f} M parameters, update s "
        f"{[round(s, 3) for s in rec['hf_gpt2']['update_s']]}, (loss, gnorm) {updates}")
    if n != GPT2_UPDATES or any(counts["gpt2_train"].values()) \
            or not all(np.isfinite(v).all() for v in updates):
        raise AssertionError(f"gpt2 train: {n} updates, launches {counts['gpt2_train']}")

    task = setup_task({"_name": "language_modeling", "data": str(fx["lm"]),
                       "tokens_per_sample": GPT2_BLOCK})
    task.load_dataset("test")
    batch_size = GPT2_XL_BATCH
    while True:
        batch = next(iter(task.make_batch_iterator(task.dataset("test"),
                                                   max_sentences=batch_size)
                          .next_epoch_itr(shuffle=False)))
        model = init_params_(task.build_model({"arch": "hf_gpt2_xl"}, device="cuda",
                                              train=True),
                             torch.Generator(device="cuda").manual_seed(64))
        step = TrainStep(model, task.build_criterion({"_name": "lm_cross_entropy"}),
                         build_optimizer(TRAIN_ADAM, list(model.parameters())),
                         build_lr_schedule({"_name": "fixed", "lr": 1e-5}),
                         compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zeroed(kernels)
        try:
            t0 = time.perf_counter()
            m = step([batch])
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            del model, step
            torch.cuda.empty_cache()
            if batch_size == 1:
                raise
            log(f"  hf_gpt2_xl: B {batch_size} does not fit; the batch is cut, not the width")
            batch_size //= 2
    counts["gpt2_xl_step"] = launches(kernels)
    rec["hf_gpt2_xl"] = dict(
        batch=list(batch["net_tokens"].shape), update_s=time.perf_counter() - t0,
        loss=m["loss"], gnorm=m["gnorm"],
        params_m=sum(p.numel() for p in model.parameters()) / 1e6,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  hf_gpt2_xl: one bf16 update of {rec['hf_gpt2_xl']['batch']} tokens in "
        f"{rec['hf_gpt2_xl']['update_s']:.2f} s (the first, with the allocator's warm-up), "
        f"{rec['hf_gpt2_xl']['params_m']:.1f} M parameters, peak "
        f"{rec['hf_gpt2_xl']['peak_memory_gb']:.2f} GB, loss {m['loss']:.2f}")
    if any(counts["gpt2_xl_step"].values()) or not np.isfinite(m["loss"]):
        raise AssertionError(f"gpt2_xl: launches {counts['gpt2_xl_step']}, {m}")
    del model, step
    torch.cuda.empty_cache()

    cfg = GPT2Config(n_embd=1600, n_head=25, n_layer=2, dropout=0.0)
    sd = import_hf_gpt2_state_dict(gpt2_state_dict(torch, cfg, 65))
    tokens = torch.from_numpy(np.asarray(list(itertools.islice(
        (int(t) for t in batch["net_tokens"].reshape(-1)), 512)), np.int64)[None])
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_hf_gpt2({"n_embd": 1600, "n_head": 25, "n_layer": 2, "dropout": 0.0},
                              device=device)
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            logits[device] = model.eval()(tokens.to(device)).cpu()
        del model
    err = max_err(logits["cuda"], logits["cpu"])
    check("gpt2 fp32 xl widths, 2 layers, 1 x 512 tokens: logits card vs CPU", err, 1e-4)
    rec["xl_2_layers_fp32_max_abs_err"] = err
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"gpt2: {rec['phase_s']:.1f} s")
    print(json.dumps({"gpt2": rec}), flush=True)
    return counts


def phase_pipe_lm(torch, fx, kernels):
    """The stacked pipeline LM: a seeded ``transformer_lm`` at
    ``transformer_lm_pipe``'s widths (6 x 512, 8 heads) saved as a native
    ``.ckpt``, stacked into ``transformer_lm_pipe`` (``stack_lm_params``),
    its fp32 logits on the card equal to the plain LM's (1e-5) on 4 blocks
    of the family's LM stream; 2 bf16 updates through ``cli.train --arch
    transformer_lm_pipe --finetune-from-model`` (one card: the layers run in
    turn); the result unstacked into a ``transformer_lm`` ``.ckpt`` and
    both scored by ``eval_lm`` in fp32 (equal within 1e-5 bits/token). No
    launches (causal). Returns the launches; prints {"pipe_lm": {...}}."""
    import shutil

    from chimera_st_tpu_torch.checkpoint.store import save_model
    from chimera_st_tpu_torch.cli import eval_lm, train
    from chimera_st_tpu_torch.cli.generate import load_language_model
    from chimera_st_tpu_torch.models.interlingua import init_params_
    from chimera_st_tpu_torch.models.pipeline_lm import (build_transformer_lm_pipe,
                                                         stack_lm_params, transformer_lm_pipe_base,
                                                         unstack_lm_params)
    from chimera_st_tpu_torch.models.transformer_mt import build_transformer_lm
    from chimera_st_tpu_torch.tasks import setup_task

    t_phase = time.perf_counter()
    root = fx["root"] / "pipe_lm"
    root.mkdir()
    task = setup_task({"_name": "language_modeling", "data": str(fx["lm"]),
                       "tokens_per_sample": LM_BLOCK})
    task.load_dataset("valid")
    widths = transformer_lm_pipe_base({"vocab_size": FAMILY_VOCAB})
    plain_cfg = dict(widths, arch="transformer_lm", attention_dropout=0.0,
                     activation_dropout=0.0)
    plain = init_params_(build_transformer_lm(plain_cfg, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(66)).eval()
    plain_ckpt = root / "plain.ckpt"
    save_model(str(plain_ckpt), plain, plain_cfg)
    stacked = stack_lm_params(load_language_model(str(plain_ckpt), task, torch.float32,
                                                  "cuda").state_dict(), widths["layers"])
    pipe_cfg = dict(widths, arch="transformer_lm_pipe")
    pipe = build_transformer_lm_pipe(pipe_cfg, device="cuda").eval()
    pipe.load_state_dict(stacked, strict=True)
    batch = next(iter(task.make_batch_iterator(task.dataset("valid"), max_sentences=4)
                      .next_epoch_itr(shuffle=False)))
    tokens = torch.from_numpy(np.asarray(batch["net_tokens"])).long().cuda()
    zeroed(kernels)
    with torch.no_grad():
        err = max_err(pipe(tokens), plain(tokens))
    check(f"pipe_lm: stacked vs plain transformer_lm fp32 logits on the card, "
          f"{tuple(tokens.shape)} tokens", err, 1e-5)
    pipe_ckpt = root / "pipe.ckpt"
    save_model(str(pipe_ckpt), pipe, pipe_cfg)
    del plain, pipe
    save_dir = root / "train"
    argv = [str(fx["lm"]), "--task", "language_modeling", "--arch", "transformer_lm_pipe",
            "--criterion", "lm_cross_entropy", "--tokens-per-sample", str(LM_BLOCK),
            "--max-tokens", str(8 * LM_BLOCK), "--optimizer", "adam", "--lr", "5e-4",
            "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4", "--dtype", "bfloat16",
            "--max-update", "2", "--train-subset", "test", "--disable-validation",
            "--no-epoch-checkpoints", "--finetune-from-model", str(pipe_ckpt),
            "--save-dir", str(save_dir)]
    with recorded_updates() as updates:
        out = train.main(argv)
    n = out["trainer"].num_updates
    rec = {"logits_max_abs_err": err, "updates": n, "update_s": out["times"]["update_s"],
           "losses": updates}
    del out
    trained = load_language_model(str(save_dir / "checkpoint_last.ckpt"), task, torch.float32,
                                  "cpu")
    unstacked = root / "unstacked.ckpt"
    back = build_transformer_lm(plain_cfg, device="cpu")
    back.load_state_dict(unstack_lm_params(trained.state_dict()), strict=True)
    save_model(str(unstacked), back, plain_cfg)
    scores = {}
    for name, path in (("pipe", save_dir / "checkpoint_last.ckpt"), ("unstacked", unstacked)):
        scores[name] = eval_lm.main([str(fx["lm"]), "--path", str(path), "--tokens-per-sample",
                                     str(LM_BLOCK), "--gen-subset", "valid", "--batch-size", "8",
                                     "--dtype", "float32"])["loss_bits"]
    check("pipe_lm: eval_lm of the trained stacked checkpoint vs its unstacked transformer_lm, "
          "bits/token", abs(scores["pipe"] - scores["unstacked"]), 1e-5)
    counts = {"pipe_lm": launches(kernels)}
    rec.update(eval_lm_bits=scores, launches=counts["pipe_lm"])
    if n != 2 or any(counts["pipe_lm"].values()) or not np.isfinite(scores["pipe"]):
        raise AssertionError(f"pipe_lm: {n} updates, launches {counts['pipe_lm']}, {scores}")
    shutil.rmtree(root)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"pipe_lm: {rec['phase_s']:.1f} s; updates (loss, gnorm) {updates}, eval_lm {scores}")
    print(json.dumps({"pipe_lm": rec}), flush=True)
    return counts


def phase_quant(torch, fx, kernels):
    """Quantization of the flagship ``_base`` state dict (the CLI
    fixture's, 12 trunk heads, 10,000-word vocabularies): scalar 8-bit fake
    quantization on the card bit-equal to the CPU's for every tensor; PQ
    (blocks of 8, 256 centroids, 15 Lloyd iterations, tensors of 4,096
    elements or more) of the whole state dict on the card, and of one of
    its matrices (a 512 x 512 projection) on the CPU from the same initial
    centroids: assignments 99 % equal (the card's ``index_add_`` sums with
    atomics, so its centroids move in the last bits from run to run and
    near-ties go either way: 99.85-100 % in the runs, and a flipped block
    moves its two centroids), the dequantized weights of the blocks assigned
    alike within 1e-2 (the matrix's weights have a std of 0.044; the runs
    differ by up to 2.0e-3) and the reconstruction MSE within 0.1 %.
    Returns the launches (none); prints {"quant": {...}}."""
    from chimera_st_tpu_torch.ops import quantization as q

    t_phase = time.perf_counter()
    sd = {k: v.detach().float() for k, v in fx["model"].state_dict().items()}
    card = {k: v.cuda() for k, v in sd.items()}
    zeroed(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = q.quantize_params_scalar(card)
    torch.cuda.synchronize()
    scalar_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = q.quantize_params_scalar(sd)
    cpu_s = time.perf_counter() - t0
    differ = [k for k in sd if not torch.equal(got[k].cpu(), want[k])]
    quantized = sum(1 for k in sd if q._quantized(sd[k], 256))
    log(f"  quant scalar: {quantized} of {len(sd)} tensors quantized; card {scalar_s:.3f} s, "
        f"CPU {cpu_s:.3f} s; tensors not bit-equal: {differ[:5]}")
    if differ:
        raise AssertionError(f"quant: scalar card vs CPU differ in {len(differ)} tensors")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense, books = q.quantize_params_pq(card)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    pq_params = sum(sd[k].numel() for k in books)
    names = ["encoder.transformer_layers.0.self_attn.q_proj.weight"]
    rec = {"scalar_card_s": scalar_s, "scalar_cpu_s": cpu_s, "scalar_tensors": quantized,
           "pq_card_s": pq_s, "pq_tensors": len(books), "pq_params_m": pq_params / 1e6,
           "pq_cpu_check": {}}
    for name in names:
        ref = q.pq_quantize(sd[name])
        agree = books[name].assignments.cpu() == ref.assignments
        same = float(agree.float().mean())
        # a block at a near-tie between two centroids may take the other
        # one on the other device: the weights are compared on the blocks
        # both assign alike, and the reconstruction error as a whole
        got_blocks = dense[name].cpu().reshape(-1, 8)
        want_blocks = q.pq_dequantize(ref).reshape(-1, 8)
        err = max_err(got_blocks[agree], want_blocks[agree])
        w = sd[name].reshape(-1, 8)
        mse = [float(((b - w) ** 2).mean()) for b in (got_blocks, want_blocks)]
        rel = abs(mse[0] - mse[1]) / mse[1]
        rec["pq_cpu_check"][name] = dict(assignments_equal=same, max_abs_err_agreeing=err,
                                         mse_card=mse[0], mse_cpu=mse[1])
        log(f"  quant PQ {name} {tuple(sd[name].shape)}: card vs CPU assignments equal "
            f"{100 * same:.3f} %; reconstruction MSE card {mse[0]:.4e}, CPU {mse[1]:.4e}")
        if same < 0.99:
            raise AssertionError(f"quant: PQ assignments of {name} agree {same:.4f}")
        check(f"quant PQ {name}: dequantized card vs CPU on the blocks assigned alike "
              f"(the weights' std {float(sd[name].std()):.3f})", err, 1e-2)
        check(f"quant PQ {name}: reconstruction MSE card vs CPU, relative", rel, 1e-3)
    counts = {"quant": launches(kernels)}
    if any(counts["quant"].values()):
        raise AssertionError(f"quant launched {counts['quant']}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"quant: {rec['phase_s']:.1f} s; PQ of {len(books)} tensors ({pq_params / 1e6:.1f} M "
        f"parameters) on the card in {pq_s:.1f} s")
    print(json.dumps({"quant": rec}), flush=True)
    del card, got, dense, books
    torch.cuda.empty_cache()
    return counts


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist1(torch, fx, work: Path, w2v2: Path, losses_a, kernels):
    """A world of one over NCCL (``--distributed-init-method
    tcp://127.0.0.1:PORT --distributed-rank 0 --distributed-num-procs 1``):
    the flagship's ``cli.train`` at train_cli's run A (2 updates) with
    ``--zero-sharding os``, validation and saves off, its losses and
    gradient norms within 1e-4 of run A's, relative (the backward's atomic
    adds vary the norm's 5th-6th digit from run to run, in one process too:
    2.6e-6, 5.3e-6 and 1.5e-5 seen); then ``cli.generate`` bf16 on the 4
    ``pairs`` wavs with the same flags (each batch gathered over the world's
    one rank), hypotheses identical to one process. This shows the wiring and NCCL's launch on the
    card, not the numbers of several ranks. The gradient buckets of the
    data-parallel sum, and how many of them started their all-reduce during
    the second update's backward, are recorded (not gated). Returns the
    launches; prints {"dist1": {...}}."""
    import torch.distributed as dist

    from chimera_st_tpu_torch.cli import train

    t_phase = time.perf_counter()
    flags = ["--distributed-init-method", f"tcp://127.0.0.1:{free_port()}",
             "--distributed-rank", "0", "--distributed-num-procs", "1"]
    zeroed(kernels)
    try:
        with recorded_updates() as updates:
            out = train.main(train_cli_argv(fx, w2v2, work / "dist1_ckpt", 2) + [
                "--disable-validation", "--no-save", "--zero-sharding", "os", *flags])
        torch.cuda.synchronize()
        counts = {"dist1_train": launches(kernels)}
        backend = dist.get_backend()
        zero = type(out["trainer"].optimizer).__name__
        reducer = out["trainer"].step.reducer
        buckets = {"buckets": len(reducer.buckets), "started_early": reducer.started_early}
        del out, reducer
        torch.cuda.empty_cache()
        # the backward's atomic adds (embedding, cuDNN) vary the gradient
        # norm in its 6th digit from run to run, in one process too, and
        # Adam carries that into the second update's loss
        for j, what in enumerate(("loss", "gnorm")):
            check(f"dist1: {what} of {len(updates)} updates vs one process, relative",
                  max(abs(got[j] - want[j]) / abs(want[j])
                      for got, want in zip(updates, losses_a)), 1e-4)
        if len(updates) != len(losses_a):
            raise AssertionError(f"dist1: {len(updates)} updates, one process {len(losses_a)}")
        decode = ["--batch-size", "4", "--dtype", "bfloat16", "--max-decode-len", "16"]
        one_text, _, _ = cli_generate(fx, work / "dist1_one", "pairs", decode)
        zeroed(kernels)
        with counted_decoder_steps() as steps:
            text, stats, wall = cli_generate(fx, work / "dist1_gen", "pairs", decode + flags)
            torch.cuda.synchronize()
        counts["dist1_decode"] = launches(kernels)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    same_hypotheses("dist1: cli.generate over a world of one vs one process",
                    parse_protocol(text)[0], parse_protocol(one_text)[0], 4)
    implied = {"encoder_attention": 24, "conv_tail": 6, "decode_attention": 6 * steps[0],
               "logmel": 0}
    if counts["dist1_train"]["conv_tail"] != 6 * 3 * 2 or counts["dist1_decode"] != implied:
        raise AssertionError(f"dist1: launches {counts} (decode wants {implied})")
    rec = {"backend": backend, "optimizer": zero, "updates": updates, "launches": counts,
           "gradient_buckets": buckets, "decode_s": stats["decode_s"],
           "phase_s": time.perf_counter() - t_phase}
    log(f"dist1: {rec['phase_s']:.1f} s; backend {backend}, {zero}; (loss, gnorm) {updates} "
        f"equal to one process; {buckets['started_early']} of {buckets['buckets']} gradient "
        f"buckets started during the last backward; decode launches {counts['dist1_decode']}")
    print(json.dumps({"dist1": rec}), flush=True)
    return counts


# ---- this slice: the host layer on the ST fine-tune's path (the training
# wire format, the waveform cache, the C++ batch packer and edit distance)

HOST_SIZES = 250_000  # MuST-C + WMT scale: the packer's hot loop
HOST_WORD_PAIRS = 10_000


def wire_copy(torch, task, wire: bool, reps: int = 20) -> dict:
    """The largest training micro-batch of the fixture (batches of 8, as
    train_cli collates them) in the wire format or as float32 with its
    mask: the bytes of its audio and mask, and the median ms of
    ``prepare_batch`` on them (pinning, the copy to the card, and on the
    wire the int16 -> float32 and the mask rebuilt there),
    card-synchronised."""
    from chimera_st_tpu_torch.data.manifests import set_wire_format
    from chimera_st_tpu_torch.train.train_step import prepare_batch

    ds = task.dataset("train_wave")
    set_wire_format(ds, int16=wire, device_mask=wire)
    batches = list(task.make_batch_iterator(ds, max_tokens=2_000_000, max_sentences=CLI_BATCH)
                   .next_epoch_itr(shuffle=False))
    set_wire_format(ds, int16=False, device_mask=False)
    batch = max(batches, key=lambda b: b["audio"].size)
    keys = ("audio", "audio_lengths") + (() if wire else ("audio_padding_mask",))
    part = {k: batch[k] for k in keys}
    n_bytes = sum(batch[k].nbytes for k in ("audio", "audio_padding_mask") if k in batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prepare_batch(part, "cuda")
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return {"audio_dtype": str(batch["audio"].dtype), "shape": list(batch["audio"].shape),
            "bytes": int(n_bytes), "mask_sent": "audio_padding_mask" in batch,
            "ms": statistics.median(times), "out": out}


def phase_host_layer(torch, fx, work: Path, w2v2: Path, losses_a, kernels):
    """The flagship's ST fine-tune through ``cli.train`` at train_cli's run
    A (2 bf16 updates of 3 micro-batches, one epoch each; validation and
    saves off), once with the default wire format (PCM16 as int16, no
    padding mask, both rebuilt on the card) and once with
    ``--no-host-wire``, each with a fresh 512 MiB waveform cache: the
    (loss, gnorm) of each update (the first loss of the two runs and of
    train_cli's run A bit-equal; the rest within 1e-4 relative of the wire
    run, which itself differs from run A, a repeat, by the backward's
    atomic adds), each epoch's data_s and the cache's hits and misses
    (epoch 2 read from the cache), K2 6 launches a micro-batch and no K1 or
    K3. Then one micro-batch's audio and mask: bytes and the copy's ms each
    way, the rebuilt float batch equal to the float one. On the host: the
    C++ batch packer against the Python loop on HOST_SIZES seeded sizes
    under the ST recipe's ``--max-tokens 2000000`` (identical batches), and
    the C++ edit distance against the Python one on HOST_WORD_PAIRS seeded
    word pairs (equal distances); the seconds of each. Returns the
    launches; prints {"host_layer": {...}}."""
    from chimera_st_tpu_torch.cli import train
    from chimera_st_tpu_torch.data import audio
    from chimera_st_tpu_torch.data.batching import batch_by_size, batch_by_size_plain
    from chimera_st_tpu_torch.scoring.wer import levenshtein, levenshtein_plain

    t_phase = time.perf_counter()
    runs, counts = {}, {}
    for label, extra in (("wire", []), ("float", ["--no-host-wire"])):
        audio.configure_wav_cache(512)
        zeroed(kernels)
        with recorded_updates() as updates:
            out = train.main(train_cli_argv(fx, w2v2, work / f"host_layer_{label}", 2)
                             + ["--disable-validation", "--no-save", *extra])
        torch.cuda.synchronize()
        counts[f"host_layer_{label}"] = launches(kernels)
        t = out["times"]
        runs[label] = {"updates": updates, "data_s": t["data_s"], "wav_cache": t["wav_cache"],
                       "epoch_s": t["epoch_s"], "update_s": t["update_s"]}
        del out
        torch.cuda.empty_cache()
    wire, flt = runs["wire"]["updates"], runs["float"]["updates"]
    if not (len(wire) == len(flt) == len(losses_a) == 2):
        raise AssertionError(f"host_layer: updates {wire} / {flt}, run A {losses_a}")
    first_equal = wire[0][0] == flt[0][0] == losses_a[0][0]
    gaps = {what: [abs(w[j] - f[j]) / abs(f[j]) for w, f in zip(wire, flt)]
            for j, what in enumerate(("loss", "gnorm"))}
    repeat = {what: [abs(w[j] - a[j]) / abs(a[j]) for w, a in zip(wire, losses_a)]
              for j, what in enumerate(("loss", "gnorm"))}
    log(f"host_layer: (loss, gnorm) wire {wire}, --no-host-wire {flt}, train_cli run A "
        f"{losses_a}; first loss bit-equal in all three: {first_equal}; relative gaps wire vs "
        f"float {gaps}, wire vs run A (a repeat) {repeat}")
    if not first_equal:
        raise AssertionError("host_layer: the first update's loss differs with the wire format")
    for what, gap in gaps.items():
        check(f"host_layer: {what} of 2 updates, wire vs float, relative", max(gap), 1e-4)
    for label, r in runs.items():
        caches = r["wav_cache"]
        log(f"  {label}: data_s {[round(x, 4) for x in r['data_s']]} (epochs 1, 2); waveform "
            f"cache after each epoch {caches}; update_s {[round(x, 3) for x in r['update_s']]}")
        if [(c["hits"], c["misses"]) for c in caches] != [(0, CLI_WAVS), (CLI_WAVS, CLI_WAVS)]:
            raise AssertionError(f"host_layer {label}: epoch 2 not read from the cache: {caches}")
        if counts[f"host_layer_{label}"] != {"encoder_attention": 0, "conv_tail": 6 * 3 * 2,
                                             "decode_attention": 0, "logmel": 0}:
            raise AssertionError(f"host_layer {label}: launches {counts[f'host_layer_{label}']}")

    task = train_task(fx)
    copies = {label: wire_copy(torch, task, label == "wire") for label in ("wire", "float")}
    rebuilt, ref = copies["wire"].pop("out"), copies["float"].pop("out")
    if not (torch.equal(rebuilt["audio"], ref["audio"])
            and torch.equal(rebuilt["audio_padding_mask"], ref["audio_padding_mask"])):
        raise AssertionError("host_layer: the wire batch rebuilt on the card is not the float one")
    log(f"  one micro-batch to the card: wire {copies['wire']}, float {copies['float']}; the "
        f"rebuilt audio and mask equal the float batch's")

    rng = np.random.default_rng(41)
    seconds = np.clip(rng.lognormal(np.log(5.0), 0.6, HOST_SIZES), 0.3, 30.0)
    sizes = (seconds * 16000).astype(np.int64)
    order = np.argsort(sizes, kind="stable")
    t0 = time.perf_counter()
    native = batch_by_size(order, sizes, max_tokens=2_000_000)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = batch_by_size_plain(order, sizes, max_tokens=2_000_000)
    plain_s = time.perf_counter() - t0
    if len(native) != len(plain) or not all(np.array_equal(a, b) for a, b in zip(native, plain)):
        raise AssertionError("host_layer: the C++ packer's batches differ from the Python loop's")
    words = [f"w{i}" for i in range(1000)]
    pairs = [(list(rng.choice(words, int(rng.integers(5, 30)))),
              list(rng.choice(words, int(rng.integers(5, 30))))) for _ in range(HOST_WORD_PAIRS)]
    t0 = time.perf_counter()
    dn = [levenshtein(a, b) for a, b in pairs]
    lev_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = [levenshtein_plain(a, b) for a, b in pairs]
    lev_plain_s = time.perf_counter() - t0
    if dn != dp:
        raise AssertionError("host_layer: the C++ edit distances differ from the Python ones")
    log(f"  batch_by_size on {HOST_SIZES:,} sizes at --max-tokens 2000000: {len(native):,} "
        f"batches, identical; C++ {native_s:.4f} s, Python {plain_s:.4f} s; levenshtein on "
        f"{HOST_WORD_PAIRS:,} word pairs: equal; C++ {lev_native_s:.4f} s, Python "
        f"{lev_plain_s:.4f} s")
    rec = {"runs": runs, "first_loss_bit_equal": first_equal, "relative_gap": gaps,
           "relative_gap_to_run_a": repeat, "copies": copies, "launches": counts,
           "batch_by_size": {"sizes": HOST_SIZES, "batches": len(native), "cpp_s": native_s,
                             "python_s": plain_s},
           "levenshtein": {"pairs": HOST_WORD_PAIRS, "cpp_s": lev_native_s,
                           "python_s": lev_plain_s},
           "phase_s": time.perf_counter() - t_phase}
    log(f"host_layer: {rec['phase_s']:.1f} s")
    print(json.dumps({"host_layer": rec}), flush=True)
    return counts


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="one more served batch per path under torch.profiler")
    ap.add_argument("--parent", type=Path, metavar="DIR",
                    help="a git archive of an earlier commit: its K3 and K4 are timed too")
    ap.add_argument("--kernels-of", type=Path, metavar="DIR",
                    help="only build the package of the tree under DIR, run phase 3's K3 and "
                         "K4 cases on it and print their records")
    args = ap.parse_args()
    t_start = time.perf_counter()
    tree = (args.kernels_of or ROOT).resolve()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (tree / "chimera_st_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    if not args.kernels_of:
        # the whole standard output also goes to chiprun_out/chip_smoke.log
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        sys.stdout = Tee(sys.stdout, open(ROOT / "chiprun_out" / "chip_smoke.log", "w"))
    sys.path.insert(0, str(tree))
    from chimera_st_tpu_torch.generation.generator import GeneratorSettings
    from chimera_st_tpu_torch.models.interlingua import ChimeraInterlinguaModel, InterlinguaConfig
    from chimera_st_tpu_torch.models.s2t_transformer import build_s2t_transformer
    from chimera_st_tpu_torch.ops import (
        _build,
        conv_tail,
        decode_attention,
        encoder_attention,
        logmel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.kernels_of:
        _build.build()
        print(json.dumps({"kernels": phase_k3_k4(torch, decode_attention, logmel)}), flush=True)
        return 0

    def mark(label):
        log(f"[{time.perf_counter() - t_start:.1f} s] {label}")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build_log = _build.build()
    state = "already built" if build_log is None else "compiled"
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path().name} {state})")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(build_log or "")
    if build_log:
        ptxas_report(build_log)
    sass = sass_check(_build.library_path(), out_dir)

    # 3. kernels
    records = phase_kernels(torch, (encoder_attention, conv_tail, decode_attention, logmel))
    if args.parent:
        merge_parent(records, args.parent.resolve())
    kernels = [r.pop("launches_of") for r in records]
    for r in records:
        r["sass"] = {op: sum(c[op] for name, c in sass.items() if name.startswith(r["name"]))
                     for op in SASS_OPS}

    # the two serving paths: seeded weights, decode settings, kernels on the path
    flagship_cfg = InterlinguaConfig(tgt_vocab_size=10000, src_vocab_size=10000)
    paths = {
        "flagship": dict(
            build=seeded_builder(torch, lambda d: ChimeraInterlinguaModel(flagship_cfg, device=d)),
            parity=GeneratorSettings(beam_size=10, max_decode_len=40, len_penalty=1.5,
                                     min_len=10),
            serve=GeneratorSettings(beam_size=10, max_decode_len=64, len_penalty=1.5,
                                    min_len=30),
            # launches a batch; K3: 6 decoder layers x 64 steps (with seeded random
            # weights no batch finishes before max_decode_len)
            on_path={"encoder_attention": 24, "conv_tail": 6, "decode_attention": 384},
            seed=2),
        "fbank": dict(
            build=seeded_builder(torch, lambda d: build_s2t_transformer(
                "s2t_transformer_s", {"tgt_vocab_size": 8000, "compute_fbank": True},
                device=d)),
            parity=GeneratorSettings(beam_size=5, max_decode_len=40),
            serve=GeneratorSettings(beam_size=5, max_decode_len=64),
            on_path={"encoder_attention": 12, "decode_attention": 384, "logmel": 1}, seed=3),
    }

    mark("kernels done")
    # 4. slice parity
    for label, p in paths.items():
        phase_parity(torch, label, p["build"], p["parity"])

    # 5. serve, each path with its own zeroed counts
    counts = {}
    for label, p in paths.items():
        model = p["build"]("cuda", torch.bfloat16)
        counts[label] = phase_serve(torch, label, model, p["serve"], kernels, p["on_path"],
                                    p["seed"], args.profile)
        del model

    mark("parity and serve done")
    # 5a. the plain w2v2 + Transformer model (no memory bank), served as the
    # flagship is
    build_w2v2 = w2v2_st_builder(torch)
    ops = (encoder_attention, conv_tail, decode_attention)
    # the shapes this slice's phases launch (w2v2_st, w2v2_st_cli, tts_update,
    # family_train), held against the plain versions after them
    slice_seen = {"encoder_attention": [], "conv_tail": [], "decode_attention": []}
    with recorded_shapes(*ops, slice_seen):
        phase_parity(torch, "w2v2_st", build_w2v2, paths["flagship"]["parity"])
        model = build_w2v2("cuda", torch.bfloat16)
        counts["w2v2_st"] = phase_serve(torch, "w2v2_st", model, paths["flagship"]["serve"],
                                        kernels, W2V2_ST_ON_PATH, 6, args.profile)
        del model
    mark("w2v2_st done")

    # 5b. the search surface on the flagship, and the fbank model on features
    build_second = seeded_builder(
        torch, lambda d: ChimeraInterlinguaModel(flagship_cfg, device=d), seed=1)
    from chimera_st_tpu_torch.models.transformer_mt import build_transformer_lm

    build_lm = seeded_builder(torch, lambda d: build_transformer_lm(
        dict(LM_GPT, vocab_size=10000), device=d), seed=4)
    search_counts, search_k3 = phase_search(torch, paths["flagship"]["build"], build_second,
                                            build_lm, kernels, decode_attention)
    counts.update({f"search_{name}": c for name, c in search_counts.items()})

    mark("w2v2_st and search done")
    # 6. the CLI phases, on a fixture under a temporary directory
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        host_probe(work)
        # the flagship as a released checkpoint builds it: 12 trunk heads
        fx = make_cli_fixture(
            torch, work / "data",
            InterlinguaConfig(tgt_vocab_size=10000, src_vocab_size=10000, w2v2_heads=12),
            W2V_CONV_FEATURE_LAYERS)
        task, loaded = phase_checkpoint(torch, fx)
        del loaded
        with recorded_shapes(*ops) as seen:
            phase_cli_parity(torch, fx, work)
            counts["cli"] = phase_cli_serve(torch, fx, work, kernels, args.profile)
            phase_interactive(torch, fx, work)
            counts["text"] = phase_text(torch, fx, task, kernels)
        with recorded_shapes(*ops, slice_seen):
            counts["w2v2_st_cli"] = phase_w2v2_ckpt(torch, fx, work, build_w2v2, kernels)
        counts["fbank_features"] = phase_fbank_features(torch, work / "fbank", kernels)
        mark("CLI phases done")
        # 7. training
        phase_train_kernels(torch, encoder_attention, conv_tail, records)
        training = train_task(fx)
        phase_train_parity(torch, training)
        counts["train"], counts["train_attention_dropout_0"], train_rec = phase_train(
            torch, training, kernels, args.profile)
        mark("train done")
        # this slice: a world of one over NCCL at train_cli's run A, its K1-K3
        # shapes (with untied's) held against the plain versions below
        a12_seen = {"encoder_attention": [], "conv_tail": [], "decode_attention": []}

        def dist1(w2v2, losses_a):
            with recorded_shapes(*ops, a12_seen):
                after = phase_dist1(torch, fx, work, w2v2, losses_a, kernels)
                mark("dist1 done")
                after.update(phase_host_layer(torch, fx, work, w2v2, losses_a, kernels))
            mark("host_layer done")
            return after

        counts["train_cli"], counts["train_cli_decode"], dist1_counts = phase_train_cli(
            torch, fx, work, kernels, train_rec, dist1)
        counts.update(dist1_counts)
        mark("train_cli done")
        with recorded_shapes(*ops, slice_seen):
            counts["tts_update"] = phase_tts_update(torch, fx, kernels)
        mark("training phases done")
        # 7a. joint MT + ST training (this slice's main path), its shapes
        # held against the plain versions below
        with recorded_shapes(*ops) as joint_seen:
            counts["joint_train"], counts["joint_train_decode"] = phase_joint_train(
                torch, fx, work, kernels)
        mark("joint_train done")
        # 8. the MT stage
        mt_fx = make_mt_fixture(work / "mt")
        phase_mt_parity(torch, mt_fx)
        mark("mt_parity done")
        mt_counts, mt_seen = phase_mt_cli(torch, mt_fx, work, kernels, encoder_attention,
                                          conv_tail, decode_attention, args.profile)
        counts.update(mt_counts)
        mark("MT stage done")
        # 9. the Transformer family
        family_fx, family_counts, family_seen = phase_family(
            torch, work, kernels, encoder_attention, conv_tail, decode_attention)
        counts.update(family_counts)
        mark("family done")
        # 10. training the Transformer family
        ensure_sacrebleu(work)
        with recorded_shapes(*ops, slice_seen):
            counts.update(phase_family_train(torch, family_fx, kernels))
        mark("family_train done")
        counts["lm_train"] = phase_lm_train(torch, family_fx, kernels)
        mark("family training done")
        # 10a. the other optimizers and schedules; the adaptive-softmax and
        # character-input LMs
        with recorded_shapes(*ops) as optim_seen:
            counts["optim_sweep"] = phase_optim_sweep(torch, family_fx,
                                                      family_fx["root"] / "mt_train", kernels)
        mark("optim_sweep done")
        counts["lm_adaptive"] = phase_lm_adaptive(torch, work, kernels)
        mark("lm_adaptive done")
        # 11. the non-autoregressive family (this slice's main path), its K1
        # shapes held against the plain version below
        with recorded_shapes(*ops) as nat_serve_seen:
            counts.update(phase_nat_serve(torch, family_fx, kernels))
        mark("nat_serve done")
        with recorded_shapes(*ops) as nat_train_seen:
            counts.update(phase_nat_train(torch, family_fx, family_fx["root"] / "mt_train",
                                          kernels))
        mark("nat_train done")
        # 12. BART / mBART and multilingual translation (this slice's main
        # path), its K1 and K3 shapes held against the plain versions below
        bart_fx = make_bart_fixture(work / "bart")
        with recorded_shapes(*ops) as bart_seen:
            bart_counts, mbart_ckpt = phase_bart_serve(torch, bart_fx, kernels)
            counts.update(bart_counts)
            mark("bart_serve done")
            counts.update(phase_bart_train(torch, bart_fx, mbart_ckpt, kernels))
            mbart_ckpt.unlink()
        mark("bart_train done")
        # 13. the wav2vec family (this slice's main path: asr_serve), its
        # K1, K2 and K3 shapes held against the plain versions below
        w2v_fx = make_w2v_fixture(torch, work / "w2v")
        with recorded_shapes(*ops) as w2v_seen:
            counts["asr_serve"] = phase_asr_serve(torch, w2v_fx, kernels)
            mark("asr_serve done")
            counts["asr_seq2seq"] = phase_asr_seq2seq(torch, w2v_fx, kernels)
            mark("asr_seq2seq done")
            counts["asr_train"], counts["asr_train_decode"] = phase_asr_train(
                torch, w2v_fx, kernels)
            mark("asr_train done")
            counts["w2v_pretrain"] = phase_w2v_pretrain(torch, w2v_fx, kernels)
            mark("w2v_pretrain done")
            counts.update(phase_bimodal_pretrain(torch, w2v_fx, kernels))
        mark("bimodal_pretrain done")
        # 14. the masked-LM family (this slice's main path: mlm_serve), its
        # K1 and K3 shapes held against the plain versions below
        mlm_fx = make_mlm_fixture(work / "mlm")
        with recorded_shapes(*ops) as mlm_seen:
            counts.update(phase_mlm_serve(torch, mlm_fx, kernels))
            mark("mlm_serve done")
            counts.update(phase_mlm_train(torch, mlm_fx, kernels))
        mark("mlm_train done")
        # 15. K1 / K3 at head dim 80 (the xlm preset), its shapes held against
        # the plain versions below; then the convolutional and recurrent zoo
        with recorded_shapes(*ops) as xlm_seen:
            counts.update(phase_xlm_serve(torch, mlm_fx, kernels))
        mark("xlm_serve done")
        counts.update(phase_zoo_lm_train(torch, family_fx, kernels))
        mark("zoo_lm_train done")
        with recorded_shapes(*ops) as zoo_seen:
            counts.update(phase_zoo_steps(torch, family_fx, kernels, records))
            mark("zoo_steps done")
            counts.update(phase_zoo_tasks(torch, work / "zoo_tasks", kernels))
        mark("zoo_tasks done")
        # 16. this slice: the untied output projection (C4), GPT-2, the
        # stacked pipeline LM, quantization
        with recorded_shapes(*ops, a12_seen):
            counts.update(phase_untied(torch, fx, work, kernels, records))
        mark("untied done")
        counts.update(phase_gpt2(torch, family_fx, kernels))
        mark("gpt2 done")
        counts.update(phase_pipe_lm(torch, family_fx, kernels))
        mark("pipe_lm done")
        counts.update(phase_quant(torch, fx, kernels))
        mark("quant done")
    # the padded batches of the fixture's wavs: the trunk at 12 heads of 64,
    # the shared encoder behind the subsampler, the text branch below one
    # 64-key tile; and the conv tail
    phase_shapes(torch, ops, seen, records, "cli", lambda sh: (
        any(H == 12 and D == 64 for _, _, H, D in sh["encoder_attention"])
        and any(T < 64 for _, T, _, _ in sh["encoder_attention"]) and bool(sh["conv_tail"])))
    # text only: validation batches of the MT stage under --max-tokens 4096
    # and its decode (batches of 32 at beam 5); the family served
    for prefix, group in (("mt", mt_seen), ("family", family_seen)):
        phase_shapes(torch, ops, group, records, prefix, lambda sh: (
            bool(sh["encoder_attention"]) and bool(sh["decode_attention"])
            and not sh["conv_tail"]))
    # this slice: w2v2_st's trunk (H 12) and shared encoder (H 4), its
    # decoder at beam 10 / H 4, the conv tail of its batches and of the TTS
    # update; family_train's micro-batches and BLEU decode (H 8, beam 4).
    # Accuracy only: they are many, and the kernels' times at such shapes
    # are phase 3's and the groups' above
    phase_shapes(torch, ops, slice_seen, records, "slice", lambda sh: (
        {(12, 64), (4, 64), (8, 64)} <= {(H, D) for _, _, H, D in sh["encoder_attention"]}
        and {(4, 10), (8, 4)} <= {(H, C) for _, H, _, _, C in sh["decode_attention"]}
        and bool(sh["conv_tail"])))

    # this slice's: joint_train's training (K2 at its ST micro-batches, timed),
    # its validation (K1 at H 12 and 8) and decode (K3 at beam 10, H 8); the
    # optimizer sweep's micro-batches (K1 at H 8). Every shape group holds
    # accuracy; the earlier groups' times are in PERF.md §6, left out of
    # this run to keep the script in its time limit
    phase_shapes(torch, ops, joint_seen, records, "joint", lambda sh: (
        {(12, 64), (8, 64)} <= {(H, D) for _, _, H, D in sh["encoder_attention"]}
        and (8, 10) in {(H, C) for _, H, _, _, C in sh["decode_attention"]}
        and bool(sh["conv_tail"])), timed=("conv_tail",))
    phase_shapes(torch, ops, optim_seen, records, "optim", lambda sh: (
        {(H, D) for _, _, H, D in sh["encoder_attention"]} == {(8, 64)}
        and not sh["conv_tail"] and not sh["decode_attention"]))

    phase_nat_shapes(torch, ops, nat_serve_seen, nat_train_seen, records)
    phase_bart_shapes(torch, ops, bart_seen, records)
    phase_w2v_shapes(torch, ops, w2v_seen, records)
    phase_mlm_shapes(torch, ops, mlm_seen, records)
    phase_xlm_shapes(torch, ops, xlm_seen, records)
    phase_zoo_shapes(torch, ops, zoo_seen, records)
    # this slice's: the untied flagship (H 12 / 8, its decoder at beam 10)
    # and the untied s2t_transformer_s (H 4, beam 5), the world of one's
    # training micro-batches (K2) and decode
    phase_shapes(torch, ops, a12_seen, records, "a12", lambda sh: (
        {(12, 64), (8, 64), (4, 64)} <= {(H, D) for _, _, H, D in sh["encoder_attention"]}
        and {(8, 10), (4, 5)} <= {(H, C) for _, H, _, _, C in sh["decode_attention"]}
        and bool(sh["conv_tail"])))
    mark("shapes done")
    # 17. report
    for r in records:
        if r["name"] == "decode_attention":
            r["search_ancestries"] = search_k3
    for r in records:
        r["launches_per_path"] = {label: c[r["name"]] for label, c in counts.items()}
        r["launches"] = sum(r["launches_per_path"].values())
        if "steps_0_63_ms" in r:
            # K3: the 64-step sweep times the counted launches
            for label, shape in (("flagship", r), ("fbank", r["fbank_shape"])):
                n = r["launches_per_path"][label] / SERVE_BATCHES
                per_batch = n / 64 * shape["steps_0_63_ms"]
                log(f"K3 {label}: {n:.0f} launches a batch x the "
                    f"measured 64-step sweep = {per_batch:.3f} ms a batch, back to back")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the start to the report")
    log(smi)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
