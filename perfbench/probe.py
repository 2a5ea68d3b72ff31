"""The traced run's instruments, from the benchmark's own files: the shapes
of every kernel launch (the ``ops`` entry points wrapped while a slice is
profiled), the profiler over that slice, and the kernels' roofline shares.
Nothing here changes the program; the wrappers are put back on exit.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

from perfbench.yardstick import counters, trace

# kernel -> a part of the CUDA kernel's name in the device trace
KERNEL_NAMES = {"K1": "encoder_attention_", "K2": "conv_tail_",
                "K3": "decode_attention_kernel", "K4": "logmel_kernel"}


@contextlib.contextmanager
def recorded_launches():
    """While open, notes every K1-K4 launch: {kernel: [(bytes, flops,
    peak) or a callable giving them after the slice]}."""
    from chimera_st_tpu_torch.ops import conv_tail as k2
    from chimera_st_tpu_torch.ops import decode_attention as k3
    from chimera_st_tpu_torch.ops import encoder_attention as k1
    from chimera_st_tpu_torch.ops import logmel as k4

    seen: Dict[str, List] = {k: [] for k in KERNEL_NAMES}
    f1, f2, f3, f4 = (k1.encoder_attention_cuda, k2.conv_tail_cuda, k3.decode_attention_cuda,
                      k4.logmel_cuda)

    def n1(q, k, v, key_padding_mask=None):
        B, T, H, D = q.shape
        size = q.element_size()
        seen["K1"].append((*counters.k1_counts(B, T, H, D, size), counters.peak_for(size)))
        return f1(q, k, v, key_padding_mask)

    def n2(x, weights):
        B, t_in, _ = x.shape
        size = x.element_size()
        for w in weights:
            t_out = (t_in - w.shape[2]) // 2 + 1
            seen["K2"].append((*counters.k2_counts(B, t_in, t_out, w.shape[2], size),
                               counters.peak_for(size)))
            t_in = t_out
        return f2(x, weights)

    def n3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam):
        N, H, _, D = k_cache.shape
        size, idx = q.element_size(), int(cache_index)
        # the ancestry tensor of a step is never written after it: keep it
        # and count the distinct rows after the slice
        seen["K3"].append(lambda a=ancestry: (
            counters.k3_bytes(a.cpu().numpy(), N // beam, beam, H, D, idx, size),
            counters.k3_flops(N, H, D, idx), counters.peak_for(size)))
        return f3(q, k_new, v_new, k_cache, v_cache, ancestry, cache_index, beam)

    def n4(wav, num_mel_bins=80):
        out = f4(wav, num_mel_bins)
        B, T = wav.shape
        mel = counters.mel_weights(num_mel_bins)
        seen["K4"].append((*counters.k4_counts(B, T, out.shape[1], num_mel_bins, mel),
                           counters.FP32_FLOPS))
        return out

    k1.encoder_attention_cuda, k2.conv_tail_cuda = n1, n2
    k3.decode_attention_cuda, k4.logmel_cuda = n3, n4
    try:
        yield seen
    finally:
        k1.encoder_attention_cuda, k2.conv_tail_cuda = f1, f2
        k3.decode_attention_cuda, k4.logmel_cuda = f3, f4


def profile_slice(run, body: Callable[[], None]) -> None:
    """Runs ``body`` (a short steady slice after the window) under
    torch.profiler with the launches recorded; sets ``run.profile``: the
    busy seconds and the trace's span, the breakdown, and per kernel its
    launches, device seconds and summed bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with recorded_launches() as seen:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_",
                                     dir=os.environ.get("TMPDIR")) as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = trace.load_events(path)
    del prof
    busy = trace.busy_of(events)
    times = trace.kernel_times(events, list(KERNEL_NAMES.values()))
    kernels = {}
    for k, part in KERNEL_NAMES.items():
        items = [x() if callable(x) else x for x in seen[k]]
        n, seconds = times[part]
        kernels[k] = {"recorded": len(items), "launches": n, "device_s": seconds,
                      "bound_s": counters.sum_bounds(items)}
    run.profile = {"busy_s": busy["device_busy_ms"] / 1e3, "window_s": busy["wall_ms"] / 1e3,
                   "busy_share": busy["busy_share"], "breakdown": trace.breakdown(events),
                   "kernels": kernels}


def roofline(run, kernel: str) -> Optional[float]:
    """The kernel's share of its roofline in the traced slice, in %: the sum
    of its launches' bounds over their device time. None where the slice
    launched it not at all, or where the trace's launches do not match the
    recorded ones."""
    if run.profile is None:
        return None
    k = run.profile["kernels"][kernel]
    if k["recorded"] == 0 or k["device_s"] <= 0:
        return None
    if k["launches"] != k["recorded"]:
        run.notes.append(f"{kernel}: {k['launches']} launches in the trace, "
                         f"{k['recorded']} recorded; no roofline")
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
