"""Tracing and timing on torch (port of ``utils/profiling.py``).

Usage::

    from pytorch_stable_diffusion_tpu_torch.utils.profiling import (
        device_trace, phase, timed)

    with phase("denoise"):            # a named range in a profiler trace
        latents = run(...)

    with timed(sync=images) as t:     # waits for the card before stopping
        images = generate(...)
    print(t.elapsed)

    # whole-program trace of host and device activity (Chrome trace JSON,
    # viewable in Perfetto or chrome://tracing):
    with device_trace("/tmp/sd_trace"):
        generate(...)

The pipeline calls none of them, as in the JAX package: they are for
callers who time or trace a request.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class _Timer:
    elapsed: float = 0.0


@contextlib.contextmanager
def phase(name: str):
    """A named range in ``torch.profiler`` traces (``record_function``) and,
    on the card, in NVTX (cheap without a profiler)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _devices(sync):
    """The devices of the tensors in ``sync`` (a tensor or a nest of lists,
    tuples and dict values of them)."""
    if isinstance(sync, torch.Tensor):
        return {sync.device}
    if isinstance(sync, dict):
        sync = list(sync.values())
    if isinstance(sync, (list, tuple)):
        return set().union(*(_devices(s) for s in sync)) if sync else set()
    return set()


@contextlib.contextmanager
def timed(sync=None):
    """Wall-clock timer; ``sync``: tensors (or a nest of them) whose
    devices are synchronized before the clock stops, so that the time
    covers the work queued on the card, not only its enqueue."""
    t = _Timer()
    start = time.perf_counter()
    try:
        yield t
    finally:
        for dev in _devices(sync):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t.elapsed = time.perf_counter() - start


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block (CPU activity, and CUDA activity where a
    card is present) and write it to ``log_dir`` as a Chrome trace
    (``trace_<pid>.json``).  Yields the ``torch.profiler.profile``, whose
    ``key_averages()`` sums the kernels by name."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
