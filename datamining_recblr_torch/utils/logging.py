"""Structured metrics logging (counterpart of
``datamining_recblr_tpu/utils/logging.py``): one JSON line per event,
the same schema, so the JAX package's plotting reads a run of the port
unchanged; the human log stream is a rendering of the same records."""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def init_logger(name: str = "recblr_torch", log_file: str | None = None):
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
    if log_file:
        # one active per-run log file: detach any previous run's
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if getattr(h, "baseFilename", None) != os.path.abspath(log_file):
                logger.removeHandler(h)
                h.close()
        have = {getattr(h, "baseFilename", None)
                for h in logger.handlers if isinstance(h, logging.FileHandler)}
        if os.path.abspath(log_file) not in have:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """JSONL event sink: {"event": ..., "time": ..., metrics...}."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            open(path, "w").close()  # truncate any previous run's file

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def epoch_records(self, event: str = "epoch"):
        return [r for r in self.records if r["event"] == event]


def load_metrics(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
