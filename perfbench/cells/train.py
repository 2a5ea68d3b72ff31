"""Training cells: the triplet fine-tune through the port's
``Trainer.train_step``, fed by the task's iterator as ``cli.train`` feeds
it (``--max-tokens`` samples a micro-batch, ``--update-freq`` of them an
update, the int16 wire).

Set-up builds the trainer once, warms the largest micro-batch up (forward
and backward, no update), then drives it through the mix's first
``checked_updates`` updates from the same feed; the reference follows those
after the window. The window then runs the same trainer on, update after
update, until ``--seconds`` have passed, and ends at a synchronise after
the last update it counts.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench import probe, traffic
from perfbench.weights import seeded_weights
from perfbench.yardstick import flops as F

EOS, PAD = 2, 1


def batch_rows(mb: Dict, utts: traffic.Utterances) -> Dict:
    """What the reference needs of one program micro-batch: its utterance
    ids and padded widths (the iterator's choice). Each row of the batch
    must hold the generated utterance bit for bit; -> also the count of rows
    that do not."""
    ids = [int(i) for i in mb["id"]]
    bad = 0
    for r, i in enumerate(ids):
        n = int(mb["audio_lengths"][r])
        tgt = np.concatenate([utts.tgt[i], [EOS]])
        src = np.concatenate([utts.src[i], [EOS]])
        ok = (n == len(utts.audio[i])
              and np.array_equal(np.asarray(mb["audio"][r, :n]).astype(np.int16), utts.audio[i])
              and not np.asarray(mb["audio"][r, n:]).any()
              and np.array_equal(mb["target"][r, :len(tgt)], tgt)
              and np.array_equal(mb["src_text"][r, :len(src)], src))
        bad += not ok
    return {"ids": ids, "T": int(mb["audio"].shape[1]), "S": int(mb["src_text"].shape[1]),
            "U": int(mb["target"].shape[1]), "ntokens": float(mb["ntokens"]), "bad": bad}


def reference_batch(rows: Dict, utts: traffic.Utterances, device) -> Dict:
    """The reference's own micro-batch from the generated utterances, padded
    to the widths the program's batch had."""
    import torch

    ids, B = rows["ids"], len(rows["ids"])
    audio = np.zeros((B, rows["T"]), np.float32)
    mask = np.ones((B, rows["T"]), bool)
    src = np.full((B, rows["S"]), PAD, np.int64)
    tgt = np.full((B, rows["U"]), PAD, np.int64)
    prev = np.full((B, rows["U"]), PAD, np.int64)
    for r, i in enumerate(ids):
        a = utts.audio[i]
        audio[r, :len(a)] = a.astype(np.float32) / 32768.0
        mask[r, :len(a)] = False
        s = np.concatenate([utts.src[i], [EOS]])
        t = np.concatenate([utts.tgt[i], [EOS]])
        src[r, :len(s)] = s
        tgt[r, :len(t)] = t
        prev[r, :len(t)] = np.concatenate([[EOS], t[:-1]])
    on = lambda x: torch.from_numpy(x).to(device)
    return {"audio": on(audio), "audio_padding_mask": on(mask), "src_text": on(src),
            "target": on(tgt), "prev_output_tokens": on(prev), "ntokens": rows["ntokens"]}


def microbatch_flops(mb: Dict, kind: str, m: Dict) -> float:
    return sum(F.train_utterance(kind, int(n), int(s), int(u), m) for n, s, u in
               zip(mb["audio_lengths"], mb["src_text_lengths"], mb["target_lengths"]))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def feed(itr, update_freq: int):
    """Each update's micro-batches, epoch after epoch, as ``cli.train``
    groups them (the mix holds more than a window needs; a faster program
    runs on into the next epoch)."""
    from chimera_st_tpu_torch.data.iterators import GroupedIterator

    while True:
        yield from GroupedIterator(itr.next_epoch_itr(shuffle=True), update_freq)
        itr.next_epoch()


def program(run, tmp: Path) -> Dict:
    """Everything the program runs; -> what the check reads of it."""
    import torch

    from chimera_st_tpu_torch.data.audio import configure_wav_cache
    from chimera_st_tpu_torch.data.manifests import set_wire_format
    from chimera_st_tpu_torch.optim import build_lr_schedule, build_optimizer
    from chimera_st_tpu_torch.tasks import setup_task
    from chimera_st_tpu_torch.train.train_step import microbatch_grad, prepare_batch
    from chimera_st_tpu_torch.train.trainer import Trainer

    from perfbench.reference.train import inverse_sqrt

    cfg, mix, rec = run.cell.config, run.cell.traffic, run.rec
    m = cfg["model"]
    kind = cfg["reference"]
    utts = traffic.generate(mix, m["src_vocab_size"], m["tgt_vocab_size"], run.seed)
    traffic.write_dataset(tmp, "train", utts, mix, m["src_vocab_size"], m["tgt_vocab_size"])
    task = setup_task({"_name": cfg["task"], "data": str(tmp), "config_yaml": "config_wave.yaml"})
    model = task.build_model({"arch": cfg["arch"], **m}, device=run.device, train=True)
    shapes = [(n, tuple(t.shape)) for n, t in model.state_dict().items()]
    model.load_state_dict(seeded_weights(shapes, run.seed, run.device))
    opt_cfg, sched_cfg = mix["optimizer"], mix["lr_scheduler"]
    optimizer = build_optimizer(opt_cfg, [p for p in model.parameters() if p.requires_grad],
                                clip_norm=float(mix.get("clip_norm", 0.0)))
    trainer = Trainer(model, task.build_criterion(mix["criterion"]), optimizer,
                      build_lr_schedule(sched_cfg),
                      getattr(torch, mix.get("dtype", "bfloat16")),
                      async_depth=int(mix["async_dispatch"]))
    trainer.set_num_updates(int(mix["start_update"]))
    dataset = task.dataset("train")
    itr = task.make_batch_iterator(dataset, max_tokens=int(mix["max_tokens"]),
                                   seed=int(mix["size_seed"]),
                                   num_length_buckets=int(mix["num_length_buckets"]),
                                   buffer_size=int(mix["data_buffer_size"]),
                                   num_workers=int(mix["num_workers"]))
    set_wire_format(dataset)

    # warm-up: the largest micro-batch, padded as the iterator pads it,
    # forward and backward without an update
    sizes = np.asarray([dataset.num_tokens(i) for i in range(len(dataset))])
    largest = max(itr.frozen_batches, key=lambda b: sizes[b].max() * len(b))
    step = trainer.step
    step.generator.manual_seed(0)
    with step.autocast():
        microbatch_grad(model, trainer.criterion,
                        prepare_batch(itr.collate(largest), run.device), step.generator,
                        step.count)
    for p in model.parameters():
        p.grad = None
    run.sync()
    configure_wav_cache(float(os.environ.get("CHIMERA_WAV_CACHE_MB", "512")))

    grouped = feed(itr, int(mix["update_freq"]))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    # the checked updates: the window's own call and feed
    checked, prog_losses, seeds, lrs = [], [], [], []
    prog_g1 = None
    for u in range(int(mix["checked_updates"])):
        micro = next(grouped)
        checked.append([batch_rows(mb, utts) for mb in micro])
        seeds.append(run.seed + trainer.num_updates)
        lrs.append(inverse_sqrt(trainer.num_updates, float(sched_cfg["lr"]),
                                int(sched_cfg["warmup_updates"])))
        trainer.train_step(micro, seed=seeds[-1])
        out = trainer.drain_metrics()
        prog_losses.append(float("nan") if out.get("nonfinite_grad") else float(out["loss"]))
        if u == 0:
            # the first gradient as Adam got it: its first moment / (1 - beta1)
            state = optimizer.optimizer.state
            g1 = torch.stack([torch.linalg.vector_norm(state[p]["exp_avg"]) if "exp_avg" in
                              state.get(p, {}) else torch.zeros((), device=run.device)
                              for _, p in named])
            prog_g1 = dict(zip([n for n, _ in named],
                               (g1 / (1.0 - float(opt_cfg["adam_betas"][0]))).tolist()))
    start = seeded_weights(shapes, run.seed, run.device)
    change = torch.stack([torch.linalg.vector_norm(p.detach() - start[n]) for n, p in named])
    prog_change = dict(zip([n for n, _ in named], change.tolist()))
    del start, change, named

    # the window
    run.sync()
    run.window["t0"] = t0 = time.perf_counter()
    updates = 0
    while True:
        with rec.span("data.wait"):
            micro = next(grouped)
        for mb in micro:
            run.work["audio_s"] += float(np.sum(mb["audio_lengths"])) / traffic.SAMPLE_RATE
            run.work["flops"] += microbatch_flops(mb, kind, m)
        rec.count("microbatches", len(micro))
        with rec.span("trainer.train_step"):
            trainer.train_step(micro, seed=run.seed + trainer.num_updates)
        updates += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    run.window["t1"] = time.perf_counter()
    before = trainer.num_updates
    trainer.drain_metrics()
    run.attempted = updates
    run.failed = before - trainer.num_updates  # updates skipped as non-finite
    run.read_peak()

    if run.trace:
        def profiled_updates():
            for _ in range(int(mix["profile_updates"])):
                with rec.mark("data.wait"):
                    micro = next(grouped)
                with rec.mark("trainer.train_step"):
                    trainer.train_step(micro, seed=run.seed + trainer.num_updates)

        probe.profile_slice(run, profiled_updates)
        trainer.drain_metrics()
    return dict(utts=utts, shapes=shapes, checked=checked, seeds=seeds, lrs=lrs,
                prog_losses=prog_losses, prog_g1=prog_g1, prog_change=prog_change)


def reference(run, utts, shapes, checked, seeds, lrs, precision: str = "fp32"):
    """The plain reference's run of the checked updates from the seeded
    weights (fp32, or the control's ``precision``) -> its summed loss a
    update, its first gradient's norms and its change after the updates,
    by leaf."""
    import torch

    from perfbench.reference.chimera import ChimeraReference
    from perfbench.reference.nn import Precision, fp32_exact
    from perfbench.reference.train import run_updates

    cfg, mix = run.cell.config, run.cell.traffic
    params = {n: t.requires_grad_() for n, t in
              seeded_weights(shapes, run.seed, run.device).items()}
    start = {n: t.detach().clone() for n, t in params.items()}
    ref = ChimeraReference(params, cfg["model"], Precision(precision))
    opt = mix["optimizer"]
    updates = [[reference_batch(r, utts, run.device) for r in mbs] for mbs in checked]
    with fp32_exact():
        losses, g1 = run_updates(ref, params, updates, seeds, lrs, mix["criterion"],
                                 tuple(float(b) for b in opt["adam_betas"]),
                                 float(opt.get("adam_eps", 1e-8)))
    names = sorted(params)
    change = torch.stack([torch.linalg.vector_norm(params[n].detach() - start[n])
                          for n in names])
    out = losses, g1, dict(zip(names, change.tolist()))
    del params, start, updates, ref
    run.free()
    return out


def gaps(losses, g1, change, ref_losses, ref_g1, ref_change) -> Dict[str, float]:
    """The compared numbers of one side's readings against the fp32
    reference's. Leaves whose reference gradient is nought to rounding
    (under a thousandth of the median leaf's) move by round-off alone and
    are left out, by that rule and not by name."""
    med = float(np.median(list(ref_g1.values())))
    live = [n for n in sorted(ref_g1) if ref_g1[n] >= 1e-3 * med and n in g1]
    return {
        "loss_gap": max(abs(p - r) / abs(r) if np.isfinite(p) else float("inf")
                        for p, r in zip(losses, ref_losses)),
        "grad_norm_gap": leaf_gap(g1, ref_g1, live),
        "change_norm_gap": leaf_gap(change, ref_change, live),
    }


def check(run, utts, shapes, checked, seeds, lrs, prog_losses, prog_g1,
          prog_change) -> Dict[str, float]:
    """Follows the checked updates with the fp32 reference and sets the
    compared numbers on ``run``; -> them."""
    bad = sum(r["bad"] for mbs in checked for r in mbs)
    run.check("rows_unlike_the_data", bad, 0)
    ref = reference(run, utts, shapes, checked, seeds, lrs)
    out = gaps(prog_losses, prog_g1, prog_change, *ref)
    for name, value in out.items():
        run.check(name, value, run.cell.limits[name])
    run.notes.append(f"reference: losses {ref[0]}, program {prog_losses}")
    return out


def control(run, utts, shapes, checked, seeds, lrs, **_) -> Dict[str, float]:
    """The control's numbers: the reference in float8 put in the program's
    place, against the fp32 reference."""
    ref = reference(run, utts, shapes, checked, seeds, lrs)
    low = reference(run, utts, shapes, checked, seeds, lrs, precision="fp8")
    return gaps(*low, *ref)


def halved(checked, utts):
    """The checked micro-batches with the first half of their rows only (a
    fault: half of the batch left out, the mean taken over the rest)."""
    out = []
    for mbs in checked:
        rows = []
        for r in mbs:
            ids = r["ids"][:max(len(r["ids"]) // 2, 1)]
            rows.append(dict(r, ids=ids, ntokens=float(sum(len(utts.tgt[i]) + 1 for i in ids))))
        out.append(rows)
    return out


def fault_half(run, utts, shapes, checked, seeds, lrs, **_) -> Dict[str, float]:
    """The fault of half the batch left out, planted in the reference put in
    the program's place, against the fp32 reference."""
    ref = reference(run, utts, shapes, checked, seeds, lrs)
    low = reference(run, utts, shapes, halved(checked, utts), seeds, lrs)
    return gaps(*low, *ref)
