"""Logging + metrics (a copy of ``ccmh/utils/logger.py``; reference parity:
utils/logger.py:7-24).

Console + file logger with the same format as the reference, plus a
jsonl metrics writer and optional TensorBoard event files.  The reference
creates a SummaryWriter but never writes a scalar to it
(utils/logger.py:21-24, no add_scalar anywhere); ccmh keeps the literal
surface (event files under <save_dir>/tensorboard) AND actually populates
it: every jsonl metric record is mirrored as add_scalar calls when
tensorboardX is importable (it is optional; without it, jsonl alone is
written).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def get_logger(filename: Optional[str] = None, name: str = "ccmh_torch") -> logging.Logger:
    logger = logging.getLogger(name if filename is None else f"{name}:{filename}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s - %(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setLevel(logging.DEBUG)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename is not None:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Append-only jsonl metrics stream: one record per event.

    ``tensorboard_dir``: also emit TensorBoard event files there (scalar
    tag ``<event>/<metric>``) — the populated version of the reference's
    writer-that-never-writes (utils/logger.py:21-24)."""

    def __init__(self, path: str, tensorboard_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                pass

    def write(self, event: str, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"event": event, "step": step, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") else v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("event", "step", "time"):
                    continue
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{event}/{k}", v, global_step=step)
            # flush per record: the Trainer holds the writer for the whole
            # run (no close hook on crash) and metric volume is a few
            # records per epoch — cheap, and events survive any exit
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._fh.close()
