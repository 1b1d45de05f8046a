"""Structured metrics logging and throughput counters.

The port's copy of ``ddqst_tpu/utils/logging.py``: a wall-clock throughput
counter, the evaluation harness's ``metrics.csv`` writer and a JSON-lines
appender.
"""

from __future__ import annotations

import csv
import json
import time


class Throughput:
    """Wall-clock counter: call ``tick(n_items)`` per step, read ``rate``."""

    def __init__(self):
        self.items = 0
        self.start = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        self.items += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self.items / e if e > 0 else 0.0


def write_metrics_csv(path: str, records: list[dict]) -> None:
    """One CSV row per record, columns in the first record's key order."""
    if not records:
        return
    keys = list(records[0].keys())
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(records)


def log_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
