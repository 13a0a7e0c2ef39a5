"""Per-frame timing rows and the CSV report (the part of
`fovtrace/app/profiler.py` that the CLI's --report needs)."""

from __future__ import annotations

from typing import Dict, List, Optional


class StageTimer:
    """Accumulates milliseconds per named quantity and one row per frame."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.frame_rows: List[Dict[str, float]] = []
        self._current: Dict[str, float] = {}

    def add(self, name: str, ms: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + ms
        self.counts[name] = self.counts.get(name, 0) + 1
        self._current[name] = ms

    def end_frame(self, extra: Optional[Dict[str, float]] = None) -> None:
        row = dict(self._current)
        if extra:
            row.update(extra)
        self.frame_rows.append(row)
        self._current = {}

    def write_csv(self, path: str) -> None:
        keys: List[str] = []
        for row in self.frame_rows:
            keys.extend(k for k in row if k not in keys)
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in self.frame_rows:
                f.write(",".join(f"{row.get(k, 0.0):.4f}" for k in keys) + "\n")
