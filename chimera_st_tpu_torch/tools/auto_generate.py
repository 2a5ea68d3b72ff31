"""Background auto-evaluator (counterpart of
chimera_st_tpu/tools/auto_generate.py): polls a save_dir for new checkpoints
and runs the port's generate CLI on each, in a process of its own; it stops
once the suicide-flag file (``auto_gen_stop`` in the save_dir unless named)
appears, after one last sweep.

    python -m chimera_st_tpu_torch.tools.auto_generate DATA_DIR --save-dir DIR \
        --gen-subset dev_wave --beam 4 [generate flags, e.g. --device cpu]
"""

from __future__ import annotations

import argparse
import logging
import subprocess
import sys
import time
from pathlib import Path

logger = logging.getLogger("chimera_st_tpu_torch.auto_generate")


def find_new_checkpoints(save_dir: Path, seen: set) -> list:
    out = []
    for p in sorted(save_dir.glob("checkpoint*.ckpt")):
        if p.name in seen or p.name == "checkpoint_last.ckpt":
            continue
        out.append(p)
    return out


def main(argv=None):
    p = argparse.ArgumentParser("chimera-auto-generate")
    p.add_argument("data")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--task", default="triplet")
    p.add_argument("--gen-subset", default="valid")
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--max-tokens", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--poll-interval", type=float, default=60.0)
    p.add_argument("--suicide-file", default=None, help="stop when this file appears")
    p.add_argument("--results-dir", default=None)
    args, extra = p.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s | auto-gen | %(message)s")

    save_dir = Path(args.save_dir)
    results = Path(args.results_dir or save_dir / "auto_eval")
    results.mkdir(parents=True, exist_ok=True)
    suicide = Path(args.suicide_file) if args.suicide_file else save_dir / "auto_gen_stop"
    seen: set = set()

    while True:
        # note the flag BEFORE the scan: checkpoints that landed before the
        # flag was raised (training saves its last/best right before touching
        # it) still get one final evaluation sweep below
        stopping = suicide.exists()
        for ckpt in find_new_checkpoints(save_dir, seen):
            seen.add(ckpt.name)
            out_file = results / f"{ckpt.stem}.{args.gen_subset}.txt"
            cmd = [
                sys.executable, "-m", "chimera_st_tpu_torch.cli.generate", args.data,
                "--task", args.task, "--path", str(ckpt),
                "--gen-subset", args.gen_subset, "--beam", str(args.beam),
                "--batch-size", str(args.batch_size),
                "--results-path", str(results), "--quiet", *extra,
            ]
            logger.info(f"evaluating {ckpt.name}")
            try:
                subprocess.run(cmd, check=True, timeout=3600)
                gen_file = results / f"generate-{args.gen_subset}.txt"
                if gen_file.exists():
                    gen_file.replace(out_file)
                    score_line = [
                        l for l in out_file.read_text().splitlines()
                        if l.startswith("Generate")
                    ]
                    if score_line:
                        logger.info(f"{ckpt.name}: {score_line[-1]}")
            except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
                logger.warning(f"eval of {ckpt.name} failed: {e}")
        if stopping:
            logger.info(f"suicide flag {suicide} found; exiting")
            return
        time.sleep(args.poll_interval)


def cli_main():
    main()


if __name__ == "__main__":
    cli_main()
