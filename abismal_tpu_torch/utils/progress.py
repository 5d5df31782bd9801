"""Byte-based mapping progress bar (src/common.hpp:46-94).

Renders `[message|====    | 42%]` in place on stderr, updated whenever the
rounded percentage changes, driven by the input file's byte position so
cost is O(percent changes), not O(reads)."""

from __future__ import annotations

import math
import sys


class ProgressBar:
    MAX_BAR_WIDTH = 72

    def __init__(self, total: int, message: str = "completion"):
        self.total = max(1, int(total))
        self.prev = 0
        self.mid_tag = message
        # pipes + "%]" + 3-wide percent field (common.hpp:82-84)
        self.bar_width = self.MAX_BAR_WIDTH - len(message) - 3 - 5

    def time_to_report(self, i: int) -> bool:
        return math.floor(100.0 * min(i, self.total) / self.total + 0.5) \
            > self.prev

    def report(self, out, i: int) -> None:
        self.prev = int(math.floor(
            100.0 * min(i, self.total) / self.total + 0.5))
        x = min(int(self.bar_width * (self.prev / 100.0)), self.bar_width)
        bar = "=" * x + " " * (self.bar_width - x)
        out.write(f"\r[{self.mid_tag}|{bar}|{self.prev:3d}%]")
        if i >= self.total:
            out.write("\n")
        out.flush()


def file_progress(path: str, message: str = "mapping reads"):
    """ProgressBar over a file's on-disk size, or None when stderr is not a
    terminal (falls back to the plain per-batch log lines)."""
    import os

    if not sys.stderr.isatty():
        return None
    try:
        return ProgressBar(os.path.getsize(path), message)
    except OSError:
        return None
