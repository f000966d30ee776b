"""Structured jsonl run logs, as ``idc_models_tpu/observe/logging.py``:
one timestamped record per epoch / round / evaluation / timer /
metrics snapshot / profile row, with the same event names and fields,
so ``stats`` reads the logs of either package."""

from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path

# arrays above this many elements are summarized, not inlined
_MAX_INLINE_ELEMENTS = 1024


class JsonlLogger:
    """Append-only jsonl writer; every record gets a wall-clock timestamp.
    Tensor and numpy scalars are written as plain numbers."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    def log(self, **record) -> None:
        rec = {"ts": time.time()}
        for k, v in record.items():
            rec[k] = _jsonable(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        """Flush + fsync before closing, so a record already logged
        survives the process."""
        if self._f.closed:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(v):
    shape = getattr(v, "shape", None)
    if shape is not None and hasattr(v, "tolist"):
        # tensors and numpy arrays: scalars as numbers, small arrays
        # inline, large ones summarized from the shape alone (never
        # copied off the card); what cannot convert is written as its
        # repr rather than failing the record and the caller's loop
        try:
            if len(shape) == 0:
                return v.item()
            if math.prod(shape) > _MAX_INLINE_ELEMENTS:
                return {"__array__": True, "shape": list(shape),
                        "dtype": str(v.dtype)}
            return v.tolist()
        except Exception:  # noqa: BLE001
            return repr(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v
