"""Trace capture: one flag profiles any training epoch.

Port of ``kfac_pytorch_tpu/training/profiling.py``: ``--profile-epoch N``
on the trainers wraps that epoch in a ``torch.profiler`` trace (host
events, and the CUDA kernels on the card) written into ``--log-dir`` as a
Chrome trace, viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

#: the Chrome trace :func:`maybe_trace` writes into its ``log_dir``
TRACE_FILE = "profile_trace.json"


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str], enabled: bool,
                device: Optional[torch.device] = None) -> Iterator[None]:
    """Capture a profiler trace into ``log_dir/profile_trace.json`` when
    ``enabled``: CPU activity always, CUDA activity when ``device`` is a
    CUDA device, the device synchronized at both edges so that the region
    holds its own kernels and no earlier ones.

    A no-op otherwise; with a warning, and no trace, when the profiler
    cannot start on this machine.
    """
    if not (enabled and log_dir):
        yield
        return
    cuda = device is not None and device.type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.__enter__()
    except RuntimeError as e:  # profiler unavailable: do not kill training
        print(f"WARNING: profiler trace unavailable: {e}")
        yield
        return
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
