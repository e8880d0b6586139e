"""ANSI terminal live view — the headless stand-in for the reference's
progressive window (platform_linux.cpp:76-86, main.cpp:387-488: ~30 Hz
refresh with Drago applied per refresh).

Renders the tonemapped frame as truecolor half-block characters (each
character cell carries two vertical pixels via foreground '▀' + background
color) so a 500x500 render previews live in a normal terminal at ~96x48
cells, refreshed per progressive pass.

NumPy only: the port's own copy of `miniraytracer_tpu/utils/terminal.py`.
"""

from __future__ import annotations

import sys

import numpy as np

CSI = "\x1b["


def ansi_frame(img: np.ndarray, cols: int = 96) -> str:
    """(H, W, 3) float [0,1] top-row-first -> ANSI truecolor string."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    cols = max(2, min(cols, w))
    rows = max(2, int(round(cols * h / w)))
    rows += rows % 2  # half-blocks consume two image rows per text row
    ys = np.minimum((np.arange(rows) * h / rows).astype(int), h - 1)
    xs = np.minimum((np.arange(cols) * w / cols).astype(int), w - 1)
    small = (np.clip(img[ys][:, xs], 0.0, 1.0) * 255.0 + 0.5).astype(int)
    lines = []
    for r in range(0, rows - 1, 2):
        top, bot = small[r], small[r + 1]
        cells = [
            f"{CSI}38;2;{t[0]};{t[1]};{t[2]}m"
            f"{CSI}48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + f"{CSI}0m")
    return "\n".join(lines)


class LiveView:
    """Stateful terminal view: clears once, then repaints in place."""

    def __init__(self, cols: int = 96, out=None):
        self.cols = cols
        self.out = out or sys.stdout
        self._started = False

    def update(self, img: np.ndarray, status: str = "") -> None:
        if not self._started:
            self.out.write(f"{CSI}2J")
            self._started = True
        body = ansi_frame(img, self.cols)
        self.out.write(f"{CSI}H{body}\n{CSI}0m{status}{CSI}0K\n")
        self.out.flush()

    def close(self) -> None:
        if self._started:
            self.out.write(f"{CSI}0m\n")
            self.out.flush()
