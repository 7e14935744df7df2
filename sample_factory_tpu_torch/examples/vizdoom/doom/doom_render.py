"""Render utilities for multi-agent Doom matches.

Copy of `sf_examples_tpu/vizdoom/doom/doom_render.py` (reference
`sf_examples/vizdoom/doom/doom_render.py`: tile per-agent frames into a grid; upscale for
human viewing). Frames here are HWC uint8
(this framework's native layout), so no channel transposes are needed on the
hot path."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def tile_grid(frames: List[np.ndarray], max_cols: int = 3) -> np.ndarray:
    """Tile N HWC frames into a single image, row-major, padded with black."""
    assert frames, "no frames to tile"
    frames = [as_hwc(f) for f in frames]
    cols = min(max_cols, len(frames))
    rows = (len(frames) + cols - 1) // cols
    blank = np.zeros_like(frames[0])
    padded = frames + [blank] * (rows * cols - len(frames))
    return np.concatenate([np.concatenate(padded[r * cols : (r + 1) * cols], axis=1) for r in range(rows)], axis=0)


def as_hwc(frame: np.ndarray) -> np.ndarray:
    """Accept CHW (engine raw) or HWC frames; return HWC."""
    if frame.ndim == 3 and frame.shape[0] <= 4 and frame.shape[-1] > 4:
        return np.transpose(frame, (1, 2, 0))
    return frame


def for_display(frame: np.ndarray, size: Optional[tuple] = (1280, 720), to_bgr: bool = True) -> np.ndarray:
    """Upscale + colorspace-convert one frame for an OpenCV window."""
    import cv2

    frame = as_hwc(frame)
    if to_bgr:
        frame = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
    if size is not None:
        frame = cv2.resize(frame, size)
    return frame
