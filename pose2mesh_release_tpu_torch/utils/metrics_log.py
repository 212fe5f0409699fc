"""Structured metric logging (observability; SURVEY.md §5: the reference
only has stdout prints + tqdm).  One JSONL line per event, flushed
immediately — greppable, plottable, survives crashes."""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"t": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
