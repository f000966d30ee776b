"""Named wall-clock spans, as ``idc_models_tpu/observe/timer.py``."""

from __future__ import annotations

import time


class Timer:
    """``with Timer("Pre-training for 10 epochs"):`` prints
    "{name} took {t} seconds"; ``.seconds`` holds the measurement, and a
    logger, when given, gets one ``timer`` record."""

    def __init__(self, name: str, *, logger=None, quiet: bool = False):
        self.name = name
        self.logger = logger
        self.quiet = quiet
        self.seconds: float | None = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        if not self.quiet:
            print(f"{self.name} took {self.seconds} seconds")
        if self.logger is not None:
            self.logger.log(event="timer", name=self.name,
                            seconds=self.seconds)
