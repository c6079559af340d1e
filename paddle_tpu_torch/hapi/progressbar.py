"""Terminal progress bar (counterpart of paddle_tpu/hapi/progressbar.py,
the reference's hapi/progressbar.py), the same code."""
from __future__ import annotations

import sys
import time

__all__ = ["ProgressBar"]


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self._file = file
        self._start = time.time()
        self._last_update = 0.0

    def update(self, current_num, values=None):
        if self._verbose == 0:
            return
        values = values or []
        now = time.time()
        msg = ""
        if self._num is not None:
            msg += f"step {current_num}/{self._num}"
            if self._verbose == 1:
                frac = min(1.0, current_num / max(1, self._num))
                filled = int(frac * self._width)
                bar = "=" * filled + ">" + "." * (self._width - filled - 1)
                msg += f" [{bar[:self._width]}]"
        else:
            msg += f"step {current_num}"
        for k, v in values:
            try:
                msg += f" - {k}: {float(v):.4f}"
            except (TypeError, ValueError):
                msg += f" - {k}: {v}"
        elapsed = now - self._start
        msg += f" - {elapsed:.0f}s"
        if self._verbose == 1:
            self._file.write("\r" + msg)
            if self._num is not None and current_num >= self._num:
                self._file.write("\n")
        else:
            if now - self._last_update > 1 or (
                    self._num is not None and current_num >= self._num):
                self._file.write(msg + "\n")
                self._last_update = now
        self._file.flush()
