"""The host's state around each map of the window, read from /proc: the
share of the machine's CPU time that went to steal (other tenants of the
host), to I/O wait and to work, the dirty and written-back page cache,
the bytes this process had written to storage and its peak resident
memory.  Printed on standard error beside the maps' seconds, so that a
run whose rate swings shows why; no metric reads it."""

from __future__ import annotations

import statistics

# /proc/stat's cpu line: user nice system idle iowait irq softirq steal
_USER, _NICE, _SYS, _IDLE, _IOWAIT, _IRQ, _SOFTIRQ, _STEAL = range(8)


def cpu_jiffies():
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except OSError:
        return None


def dirty_mb():
    """Dirty plus Writeback of the page cache, MB."""
    try:
        kb = 0
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("Dirty:", "Writeback:")):
                    kb += int(line.split()[1])
        return kb / 1024
    except OSError:
        return None


def written_mb():
    """Bytes this process caused to be written to storage, MB."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        return None
    return None


def peak_rss_mb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


class HostLog:
    """One sample of the host a map: call mark() before the window and
    after each map."""

    def __init__(self):
        self.rows = []  # (steal, iowait, busy) shares, dirty MB
        self._last = cpu_jiffies()

    def mark(self):
        now = cpu_jiffies()
        if now is None or self._last is None:
            return
        d = [b - a for a, b in zip(self._last, now)]
        self._last = now
        tot = sum(d) or 1
        busy = tot - d[_IDLE] - d[_IOWAIT] - d[_STEAL]
        self.rows.append((d[_STEAL] / tot, d[_IOWAIT] / tot, busy / tot,
                          dirty_mb()))

    def lines(self, map_s) -> list:
        if not self.rows:
            return []
        cols = list(zip(*self.rows))
        fmt = " ".join
        out = [
            "host steal % a map: " + fmt(f"{100 * x:.1f}" for x in cols[0]),
            "host iowait % a map: " + fmt(f"{100 * x:.1f}" for x in cols[1]),
            "host busy % a map: " + fmt(f"{100 * x:.1f}" for x in cols[2]),
            "host dirty+writeback MB a map: "
            + fmt(f"{x:.0f}" if x is not None else "-" for x in cols[3])]
        n = min(len(map_s), len(cols[0]))
        if n > 2 and len(set(map_s[:n])) > 1 and len(set(cols[0][:n])) > 1:
            r = statistics.correlation(map_s[:n], cols[0][:n])
            out.append(f"host: correlation of a map's seconds with its "
                       f"steal {r:.3f}")
        w = written_mb()
        if w is not None:
            out.append(f"host: this process wrote {w:.0f} MB to storage")
        out.append(f"host: peak resident {peak_rss_mb():.0f} MB")
        return out
