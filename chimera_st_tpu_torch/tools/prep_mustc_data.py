"""MuST-C data preparation (counterpart of
chimera_st_tpu/tools/prep_mustc_data.py; Chimera's
``prepare_data/prep_mustc_data.py`` and ``data_utils.gen_config_yaml``): the
segment YAML and parallel texts of each split -> a TSV manifest, and the
data config.

For ``--task wave`` (the Chimera recipes) the audio column addresses raw
waveform slices ``wav_path:frame_offset:frame_length`` and ``n_frames`` is
the sample count. ``--task fbank80`` writes each segment's 80-bin log-mel
(the plain version of K4 on the CPU, ``ops/fbank.py`` ``logmel_plain``, in
float64) to a ``.npy`` instead.

MuST-C layout: {root}/en-{lang}/data/{split}/wav/*.wav +
{split}/txt/{split}.yaml (segments) + {split}.en / {split}.{lang} texts.

    python -m chimera_st_tpu_torch.tools.prep_mustc_data --data-root MUSTC \
        --langs de --task wave --spm-model spm.model --vocab spm.txt
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

logger = logging.getLogger("chimera_st_tpu_torch.prep_mustc")

SPLITS = ["train", "dev", "tst-COMMON", "tst-HE"]


def gen_config_yaml(
    root: Path,
    spm_model: str,
    vocab_filename: str,
    yaml_filename: str = "config_wave.yaml",
    use_audio_input: bool = True,
    src_spm_model: str = None,
    src_vocab_filename: str = None,
    specaugment: bool = False,
):
    """The data config: the vocabulary, the sentencepiece model, raw audio
    or fbank input (with utterance CMVN and SpecAugment transforms)."""
    cfg = {
        "audio_root": str(root),
        "vocab_filename": vocab_filename,
        "bpe_tokenizer": {"bpe": "sentencepiece", "sentencepiece_model": spm_model},
        "use_audio_input": use_audio_input,
        "input_feat_per_channel": 80,
        "shuffle": True,
    }
    if src_spm_model:
        cfg["src_bpe_tokenizer"] = {
            "bpe": "sentencepiece",
            "sentencepiece_model": src_spm_model,
        }
    if src_vocab_filename:
        cfg["src_vocab_filename"] = src_vocab_filename
    if specaugment and not use_audio_input:
        cfg["transforms"] = {
            "_train": ["utterance_cmvn", "specaugment"],
            "_eval": ["utterance_cmvn"],
            "specaugment": {
                "freq_mask_N": 1, "freq_mask_F": 27,
                "time_mask_N": 1, "time_mask_T": 100, "time_mask_p": 1.0,
            },
        }
    import yaml

    with open(root / yaml_filename, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    logger.info(f"wrote {root / yaml_filename}")


def process_split(
    lang_root: Path, split: str, lang: str, task: str, sample_rate: int = 16000
):
    import yaml

    txt_dir = lang_root / "data" / split / "txt"
    wav_dir = lang_root / "data" / split / "wav"
    with open(txt_dir / f"{split}.yaml") as f:
        segments = yaml.safe_load(f)
    with open(txt_dir / f"{split}.en", encoding="utf-8") as f:
        src_texts = [l.strip() for l in f]
    with open(txt_dir / f"{split}.{lang}", encoding="utf-8") as f:
        tgt_texts = [l.strip() for l in f]
    assert len(segments) == len(src_texts) == len(tgt_texts)

    rows = []
    for i, seg in enumerate(segments):
        wav_path = wav_dir / seg["wav"]
        offset = int(float(seg["offset"]) * sample_rate)
        n_frames = int(float(seg["duration"]) * sample_rate)
        utt_id = f"{wav_path.stem}_{i}"
        if task == "wave":
            audio = f"{wav_path}:{offset}:{n_frames}"
        else:  # fbank80: extract log-mel features to .npy
            import numpy as np
            import torch

            from ..data.audio import read_wav
            from ..ops.fbank import logmel_plain

            feat_dir = lang_root / f"fbank80_{split}"
            feat_dir.mkdir(exist_ok=True)
            wav, _ = read_wav(str(wav_path), frame_offset=offset, frames=n_frames)
            feats = logmel_plain(torch.from_numpy(wav.astype(np.float64))[None])[0]
            feats = feats.numpy().astype(np.float32)
            np.save(feat_dir / f"{utt_id}.npy", feats)
            audio = str(feat_dir / f"{utt_id}.npy")
            n_frames = feats.shape[0]
        rows.append({
            "id": utt_id,
            "audio": audio,
            "n_frames": n_frames,
            "tgt_text": tgt_texts[i],
            "speaker": seg.get("speaker_id", "spk"),
            "src_text": src_texts[i],
        })
    return rows


def write_tsv(rows, path: Path):
    cols = ["id", "audio", "n_frames", "tgt_text", "speaker", "src_text"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(str(r[c]) for c in cols) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser("chimera-torch-prep-mustc")
    p.add_argument("--data-root", required=True, help="MuST-C root (contains en-XX/)")
    p.add_argument("--langs", nargs="+", default=["de"])
    p.add_argument("--task", default="wave", choices=["wave", "fbank80"])
    p.add_argument("--spm-model", required=True,
                   help="joint sentencepiece model (chimera/resources/*-spm)")
    p.add_argument("--vocab", required=True, help="fairseq-format vocab file")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s | %(message)s")

    root = Path(args.data_root)
    for lang in args.langs:
        lang_root = root / f"en-{lang}"
        if not lang_root.is_dir():
            logger.warning(f"skipping missing {lang_root}")
            continue
        for split in SPLITS:
            if not (lang_root / "data" / split).is_dir():
                continue
            rows = process_split(lang_root, split, lang, args.task)
            out = lang_root / f"{split}_{args.task}.tsv"
            write_tsv(rows, out)
            logger.info(f"{out}: {len(rows)} utterances")
        import shutil

        shutil.copy(args.spm_model, lang_root / Path(args.spm_model).name)
        shutil.copy(args.vocab, lang_root / Path(args.vocab).name)
        gen_config_yaml(
            lang_root,
            spm_model=str(lang_root / Path(args.spm_model).name),
            vocab_filename=Path(args.vocab).name,
            yaml_filename=("config_wave.yaml" if args.task == "wave"
                           else "config_fbank.yaml"),
            use_audio_input=args.task == "wave",
            src_spm_model=str(lang_root / Path(args.spm_model).name),
            src_vocab_filename=Path(args.vocab).name,
            specaugment=args.task != "wave",
        )


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
