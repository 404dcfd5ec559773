"""Progress reporting with ETA (util/progressreporter.h:26-44 analog;
this package's copy of the JAX package's ``utils/progress.py``)."""

from __future__ import annotations

import sys
import time


class Timer:
    """Elapsed-seconds timer (util/progressreporter.h Timer)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0


class ProgressReporter:
    """Console progress bar with ETA, update()/done() interface."""

    def __init__(self, total, title="Rendering", quiet=False, out=sys.stderr):
        self.total = max(int(total), 1)
        self.title = title
        self.quiet = quiet
        self.out = out
        self.count = 0
        self.timer = Timer()
        self._last_len = 0

    def update(self, n=1):
        self.count += n
        if self.quiet:
            return
        frac = min(self.count / self.total, 1.0)
        el = self.timer.elapsed()
        eta = el / max(frac, 1e-9) * (1 - frac)
        bar_w = 28
        filled = int(bar_w * frac)
        line = (f"\r{self.title}: [{'+' * filled}{' ' * (bar_w - filled)}] "
                f"{100 * frac:5.1f}%  ({el:.1f}s|{eta:.1f}s)")
        pad = max(self._last_len - len(line), 0)
        self.out.write(line + " " * pad)
        self.out.flush()
        self._last_len = len(line)

    def done(self):
        if not self.quiet:
            self.update(0)
            self.out.write("\n")
            self.out.flush()
