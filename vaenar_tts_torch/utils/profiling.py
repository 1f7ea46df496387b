"""Profiler traces (counterpart of ``vaenar_tts_tpu/utils/profiling.py``).

``profile_trace(log_dir)`` runs its block under ``torch.profiler`` (CPU
and, when there is a card, CUDA activity) and writes a Chrome trace to
``log_dir/trace.json``; with no ``log_dir`` it does nothing. It yields the
profiler (or None), so that a caller can read ``key_averages()``.
``device_summary`` reads one: the device time, the kernel launches and the
operations that took the most device time.

The JAX package's ``RetraceMonitor`` has no counterpart: it counts jit
recompilations, and eager PyTorch compiles nothing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[Optional[object]]:
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_summary(prof, reps: int = 1, top: int = 10) -> Dict[str, object]:
    """{"device_ms", "launches", "top": [[name, ms, calls], ...]} of a
    finished profile over ``reps`` repetitions, each per repetition: the
    device kernels' summed own time (one stream, so they do not overlap),
    their calls, and the ``top`` kernels by device time. A user annotation
    spans the kernels inside it on the device timeline and is left out."""
    import torch
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not e.is_user_annotation]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / reps,
            "launches": sum(e.count for e in kernels) / reps,
            "top": [[e.key[:90], e.self_device_time_total / 1e3 / reps, e.count / reps]
                    for e in kernels[:top]]}
