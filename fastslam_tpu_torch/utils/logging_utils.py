"""Structured logging: a copy of ``fastslam_tpu/utils/logging_utils.py``
(plain Python).

``get_logger`` returns a std-logging logger with a compact single-line
format; ``MetricsLog`` appends machine-readable JSONL metric records (tick
metrics, health reports, resampling events) for offline analysis.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


_FORMAT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"


def get_logger(name: str = "fastslam", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, _DATEFMT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsLog:
    """Append-only JSONL metrics stream."""

    def __init__(self, path: Optional[str]):
        self._f = None
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(path, "a")

    def write(self, kind: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"t": round(time.time(), 3), "kind": kind, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
