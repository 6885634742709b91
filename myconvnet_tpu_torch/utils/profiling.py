"""Profiling: a ``torch.profiler`` trace of the enclosed steps.

Port of ``myconvnet_tpu/utils/profiling.py:19`` (``trace``): where JAX
writes a ``jax.profiler`` trace, the port records the host and, on a
CUDA device, the card's kernels, and writes one Chrome trace,
``<log_dir>/trace.json`` (Perfetto or ``chrome://tracing`` open it).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed code::

        with profiling.trace("runs/x/trace"):
            net.train(...)
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
