"""Live progressive display: ANSI truecolor terminal rendering.

The reference pops a CImg window and refreshes it per chunk
(image/image.cpp:3-18, main.cpp:20-40). Render hosts are headless, so the
live-display parity is a terminal renderer: each pixel pair becomes a
U+2580 upper-half-block with truecolor fore/background, refreshed in place
with cursor-home escapes. Falls back to doing nothing when stdout is not a
terminal (e.g. driver logs), like `--no-show`.
"""

from __future__ import annotations

import os
import sys

import numpy as np


class TerminalDisplay:
    """Progressive in-terminal image view (the CImg window analogue)."""

    def __init__(self, width: int, height: int, max_cols: int = 96, stream=None):
        self.stream = stream if stream is not None else sys.stdout
        self.enabled = hasattr(self.stream, "isatty") and self.stream.isatty()
        # downscale factor to fit the terminal
        cols = min(max_cols, self._term_cols())
        self.step = max(1, -(-width // cols))
        self._first = True

    @staticmethod
    def _term_cols() -> int:
        try:
            return os.get_terminal_size().columns
        except OSError:
            return 80

    def update(self, img: np.ndarray) -> None:
        """Redraw from a uint8 [H, W, 3] frame."""
        if not self.enabled:
            return
        small = img[:: self.step * 2, :: self.step]  # 2 rows per glyph row
        top = img[self.step :: self.step * 2, :: self.step]
        h = min(small.shape[0], top.shape[0])
        out = []
        if self._first:
            out.append("\x1b[2J")
            self._first = False
        out.append("\x1b[H")
        for r in range(h):
            row = []
            for c in range(small.shape[1]):
                fr, fg, fb = (int(v) for v in small[r, c])
                br, bg, bb = (int(v) for v in top[r, c])
                row.append(f"\x1b[38;2;{fr};{fg};{fb}m\x1b[48;2;{br};{bg};{bb}m▀")
            out.append("".join(row) + "\x1b[0m\n")
        self.stream.write("".join(out))
        self.stream.flush()

    def close(self) -> None:
        if self.enabled:
            self.stream.write("\x1b[0m\n")
            self.stream.flush()
