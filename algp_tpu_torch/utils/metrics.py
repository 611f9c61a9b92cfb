"""Structured per-round metrics (a copy of algp_tpu.utils.metrics).

Every episode round emits one flat dict (RMSE, mean posterior variance,
timings), optionally streamed as JSONL.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class MetricsLogger:
    """Collects per-round metric dicts; optionally streams JSONL."""

    def __init__(self, stream: Optional[IO] = None):
        self.history: list[dict] = []
        self.stream = stream
        self._t0 = time.perf_counter()

    def log(self, **kv) -> dict:
        rec = {"t_wall": round(time.perf_counter() - self._t0, 4), **kv}
        self.history.append(rec)
        if self.stream is not None:
            self.stream.write(json.dumps(rec) + "\n")
            self.stream.flush()
        return rec

    def last(self) -> dict:
        return self.history[-1] if self.history else {}

    def series(self, key: str) -> list:
        return [h[key] for h in self.history if key in h]
