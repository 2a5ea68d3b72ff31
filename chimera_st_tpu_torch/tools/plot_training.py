"""Training-log curves and the best epoch (counterpart of
chimera_st_tpu/tools/plot_training.py; Chimera's ``tools/plot_output.py``):
parses the train CLI's log lines (``time | LEVEL | logger | message``), in
its three shapes, accumulates the stats of each split, plots chosen stats
and reports the best epoch under a metric and a polarity.

- JSON progress lines     {"epoch": 1, "update": 0.25, "loss": "3.214", ...}
- simple progress lines   epoch 001:     5 / 20  loss=3.214, ups=1.2
- validation lines        validation | loss 3.214 | nll_loss 2.981

    python -m chimera_st_tpu_torch.tools.plot_training -f train.log \
        -i curves.png -l stats.json --stat-types loss nll_loss \
        --best-epoch-according-to valid_loss --best-epoch-polarity min
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# progress-line shapes (after the logging-format header is stripped)
_SIMPLE_RE = re.compile(r"^epoch (\d+):\s*(\d+) / (\d+)\s+(.*)$")
_KV_COMMA_RE = re.compile(r"([\w:@.-]+)=([^,]+)")


def _strip_header(line: str) -> str:
    """Drop the ``time | LEVEL | logger | `` prefix if present."""
    parts = line.rstrip("\n").split(" | ", 3)
    if len(parts) == 4 and parts[1].strip() in (
        "INFO", "WARNING", "ERROR", "DEBUG", "CRITICAL",
    ):
        return parts[3]
    return line.rstrip("\n")


def _to_float(v: str) -> Optional[float]:
    try:
        x = float(v)
    except (TypeError, ValueError):
        return None
    return x if x == x else None  # nan is dropped


def parse_line(msg: str) -> Optional[Tuple[str, Dict[str, float]]]:
    """-> (split, stats) where split is 'train' or 'valid', or None."""
    msg = msg.strip()
    if msg.startswith("{") and msg.endswith("}"):
        try:
            obj = json.loads(msg)
        except json.JSONDecodeError:
            return None
        stats = {}
        for k, v in obj.items():
            x = _to_float(v)
            if x is not None:
                stats[k] = x
        return ("train", stats) if stats else None
    m = _SIMPLE_RE.match(msg)
    if m:
        stats = {"epoch": float(m.group(1))}
        size = float(m.group(3))
        if size:
            stats["update"] = float(m.group(1)) - 1 + float(m.group(2)) / size
        for k, v in _KV_COMMA_RE.findall(m.group(4)):
            x = _to_float(v.strip())
            if x is not None:
                stats[k] = x
        return "train", stats
    if msg.startswith("validation |"):
        stats = {}
        for field in msg.split(" | ")[1:]:
            kv = field.strip().split()
            if len(kv) == 2:
                x = _to_float(kv[1])
                if x is not None:
                    stats[kv[0]] = x
        return ("valid", stats) if stats else None
    return None


def parse_logs(paths: List[str]) -> Dict[str, List[Dict[str, float]]]:
    """-> {'train': [stats...], 'valid': [stats...]} in file order.

    Validation lines carry no epoch themselves; they inherit the last train
    epoch seen (the train CLI validates at epoch ends and save intervals)."""
    out: Dict[str, List[Dict[str, float]]] = {"train": [], "valid": []}
    last_epoch = 0.0
    for path in paths:
        with open(path) as fh:
            for raw in fh:
                parsed = parse_line(_strip_header(raw))
                if parsed is None:
                    continue
                split, stats = parsed
                if split == "train" and "epoch" in stats:
                    last_epoch = stats["epoch"]
                if split == "valid":
                    stats.setdefault("epoch", last_epoch)
                out[split].append(stats)
    return out


def best_epoch(
    records: Dict[str, List[Dict[str, float]]],
    according_to: str = "valid_loss",
    polarity: str = "min",
) -> Optional[Tuple[float, float]]:
    """-> (epoch, value) of the best record, or None.

    ``according_to`` is '<split>_<stat>' (``valid_loss``) or a bare stat
    name looked up in valid, then train."""
    if "_" in according_to and according_to.split("_", 1)[0] in records:
        split, stat = according_to.split("_", 1)
        candidates = [(split, stat)]
    else:
        candidates = [("valid", according_to), ("train", according_to)]
    pts = []
    for split, stat in candidates:
        pts = [
            (r["epoch"], r[stat])
            for r in records.get(split, ())
            if stat in r and "epoch" in r
        ]
        if pts:
            break
    if not pts:
        return None
    pick = min if polarity == "min" else max
    return pick(pts, key=lambda p: p[1])


def plot_curves(
    records: Dict[str, List[Dict[str, float]]],
    stat_types: List[str],
    save_image: str,
):
    import matplotlib

    matplotlib.use("Agg")  # no display
    import matplotlib.pyplot as plt

    n = len(stat_types)
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.5 * rows),
                             squeeze=False)
    for i, stat in enumerate(stat_types):
        ax = axes[i // cols][i % cols]
        for split, marker in (("train", "-"), ("valid", "o--")):
            xs, ys = [], []
            for r in records.get(split, ()):
                if stat in r:
                    xs.append(r.get("update", r.get("epoch", len(xs))))
                    ys.append(r[stat])
            if xs:
                ax.plot(xs, ys, marker, label=split, markersize=3)
        ax.set_title(stat)
        ax.set_xlabel("epoch")
        ax.legend()
    fig.tight_layout()
    fig.savefig(save_image, dpi=100)
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--files", "-f", nargs="+", required=True)
    p.add_argument("--save-image", "-i", default="")
    p.add_argument("--save-log", "-l", default="",
                   help="write parsed records + best epoch as JSON")
    p.add_argument("--no-fig", "-n", action="store_true")
    p.add_argument("--stat-types", nargs="+", default=[],
                   help="stats to plot (default: every stat seen)")
    p.add_argument("--best-epoch-according-to", default="valid_loss")
    p.add_argument("--best-epoch-polarity", default="min",
                   choices=("min", "max"))
    args = p.parse_args(argv)

    records = parse_logs(args.files)
    stats_seen = sorted(
        {k for rs in records.values() for r in rs for k in r}
        - {"epoch", "update"}
    )
    stat_types = args.stat_types or stats_seen

    best = best_epoch(records, args.best_epoch_according_to,
                      args.best_epoch_polarity)
    if best is not None:
        print(f"best epoch {best[0]:g} "
              f"({args.best_epoch_according_to}={best[1]:g})")
    else:
        print(f"no records carry {args.best_epoch_according_to}")

    if args.save_log:
        with open(args.save_log, "w") as fh:
            json.dump({"records": records, "best": best,
                       "metric": args.best_epoch_according_to}, fh, indent=1)
    if args.save_image and not args.no_fig:
        if not stat_types:
            print("no plottable stats found in the given logs; skipping figure")
        else:
            plot_curves(records, stat_types, args.save_image)
            print(f"saved {args.save_image}")
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
