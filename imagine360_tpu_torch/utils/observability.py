"""Logging, stage timing and device memory (counterpart of
imagine360_tpu/utils/observability.py)."""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch


def get_logger(name: str = "imagine360") -> logging.Logger:
    logger = logging.getLogger(f"imagine360_tpu_torch.{name}")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class StageTimer:
    """Context-manager stage timer collecting a {stage: seconds} report.
    With `device` a CUDA device, a stage ends in `torch.cuda.synchronize`,
    so its seconds hold the device work it enqueued. `split(name)` times a
    part of a stage the same way, unlogged, into `splits`."""

    def __init__(self, logger: Optional[logging.Logger] = None, device=None):
        self.logger = logger
        self.stages: dict[str, float] = {}
        self.splits: dict[str, float] = {}
        self._cuda = device if device is not None and torch.device(device).type == "cuda" \
            else None

    @contextlib.contextmanager
    def split(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda is not None:
                torch.cuda.synchronize(self._cuda)
            self.splits[name] = self.splits.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda is not None:
                torch.cuda.synchronize(self._cuda)
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if self.logger:
                self.logger.info("stage %-14s %.3fs", name, dt)

    def report(self) -> dict:
        return dict(self.stages)


def split(timer: Optional[StageTimer], name: str):
    """`timer.split(name)`, or nothing without a timer."""
    return contextlib.nullcontext() if timer is None else timer.split(name)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler trace of the block, CPU and (where present) CUDA
    activities, written into `logdir` as a Chrome trace (chrome://tracing,
    Perfetto); counterpart of the JAX package's jax.profiler trace.
    Yields the profiler; its `trace_path` names the file once the block
    ends."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def device_memory_stats() -> dict:
    """Per-device memory from torch.cuda.memory_stats: {device: {bytes_in_use,
    peak_bytes_in_use, bytes_limit}}; empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
