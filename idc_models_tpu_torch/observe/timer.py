"""Named wall-clock spans and the profiler hook, as
``idc_models_tpu/observe/timer.py``.

`Timer` prints "{name} took {t} seconds" around an expensive phase and,
while a tracer is armed (``observe/trace.py``), records a span of the
same name. `profile_trace` wraps a region in ``torch.profiler`` over the
CPU and CUDA activities and writes a Chrome trace under the directory
it is given (the counterpart of ``jax.profiler.trace``); it also arms
program accounting for the region (``observe/profile.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

from idc_models_tpu_torch.observe import trace


class Timer:
    """``with Timer("Pre-training for 10 epochs"):`` prints
    "{name} took {t} seconds"; ``.seconds`` holds the measurement, and a
    logger, when given, gets one ``timer`` record.

    When a tracer is active the Timer also records a span of the same
    name (``timer=True``), so every Timer call site shows up in exported
    traces; with tracing disabled the span handle is the shared no-op."""

    def __init__(self, name: str, *, logger=None, quiet: bool = False):
        self.name = name
        self.logger = logger
        self.quiet = quiet
        self.seconds: float | None = None

    def __enter__(self) -> "Timer":
        self._span = trace.span(self.name, timer=True).__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        if not self.quiet:
            print(f"{self.name} took {self.seconds} seconds")
        if self.logger is not None:
            self.logger.log(event="timer", name=self.name,
                            seconds=self.seconds)


@contextlib.contextmanager
def profile_trace(logdir: str | os.PathLike | None):
    """``torch.profiler`` over the block, CPU and CUDA activities (CUDA
    only when the card is there), exported as a Chrome trace to
    ``<logdir>/trace.json`` (Perfetto / chrome://tracing). Program
    accounting is armed inside the block, so `fit` and `run_rounds`
    count their first step or attempt and file it as ``train.step`` /
    ``fed.round`` (the ``program_*`` gauges of the metrics snapshot). A
    no-op when `logdir` is None, so call sites can be unconditional."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from idc_models_tpu_torch.observe import profile as program

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    armed = program.accounting_enabled()
    program.enable_accounting(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        program.enable_accounting(armed)
    prof.export_chrome_trace(str(out / "trace.json"))
