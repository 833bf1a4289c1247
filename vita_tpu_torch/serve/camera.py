"""Camera frame buffer for the duplex loop: video context per VAD query.

The reference's interactive demo keeps the most recent webcam frames in a
bounded buffer and, at each VAD-segmented query, writes them to an mp4
that rides along with the audio (web_demo/web_interactive_demo.py:706-720,
864-865 — `collect_frames` keeps `max_frames=8`, the query handler attaches
the clip). The mp4 round-trip is a gradio/browser artifact; here frames
stay raw uint8 arrays and are tiled directly into the vision tower's
input at query time (patch mode: one tile per frame; frameCat mode:
5-tuple groups via assemble_framecat_frames, short buffers padded by
repeating the last frame the way sparse sampling duplicates positions).

A copy of vita_tpu.serve.camera, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np


class CameraBuffer:
    """Ring of the last ``max_frames`` camera frames (uint8 [H, W, 3])."""

    def __init__(self, max_frames: int = 8):
        self.frames: deque = deque(maxlen=max_frames)

    def push(self, frame: np.ndarray) -> None:
        f = np.asarray(frame)
        if f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != 3:
            raise ValueError(f"camera frame must be uint8 [H,W,3], got "
                             f"{f.dtype} {f.shape}")
        self.frames.append(f)

    def __len__(self) -> int:
        return len(self.frames)

    def snapshot_tiles(self, fusion: str) -> Tuple[Optional[List[np.ndarray]], int]:
        """Returns (tiles, n_groups) for the current buffer, or (None, 0)
        when no frames have arrived. ``n_groups`` is the number of
        ``<image>`` sentinel groups (tiles per group: 5 under frameCat,
        1 under patch fusion)."""
        frames = list(self.frames)
        if not frames:
            return None, 0
        if fusion == "framecat":
            from vita_tpu_torch.data.image import assemble_framecat_frames

            # pad to a multiple of 4 by repeating the last frame — the
            # same duplication the sparse video sampler applies to short
            # clips (data/video.py frames clamp; ...neg_frameCat.py:442-556)
            while len(frames) % 4:
                frames.append(frames[-1])
            tiles = assemble_framecat_frames(frames)
            return tiles, len(tiles) // 5
        return frames, len(frames)


def synthetic_camera_frames(n: int, size: int, seed: int = 0) -> List[np.ndarray]:
    """Deterministic synthetic webcam: a bright square orbiting a gray
    field (enough structure for smoke tests without real capture)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(90, 120, (size, size, 3)).astype(np.uint8)
    frames = []
    side = max(size // 4, 1)
    for i in range(n):
        f = base.copy()
        cx = int((np.cos(i / 6.0) * 0.35 + 0.5) * (size - side))
        cy = int((np.sin(i / 6.0) * 0.35 + 0.5) * (size - side))
        f[cy : cy + side, cx : cx + side] = (250, 40 + (i * 9) % 200, 60)
        frames.append(f)
    return frames


def video_file_frames(path: str, size: int) -> List[np.ndarray]:
    """Sequential full read of a camera-feed recording, resized square —
    the demo replays it at the mic-chunk cadence."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = []
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            frames.append(cv2.resize(rgb, (size, size),
                                     interpolation=cv2.INTER_AREA))
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return frames
