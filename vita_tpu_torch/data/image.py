"""Host-side image preprocessing: dynamic aspect-ratio tiling + normalization
(a copy of vita_tpu.data.image, so that the port loads no module of the
reference package; tests/test_torch_data.py holds it equal to the original).

Two tiling schemes, matching the reference's behavior exactly:

  - ``dynamic_tile`` — InternVL-style: pick the (cols, rows) grid whose
    aspect ratio is closest to the image's (ties broken toward more area),
    resize to the grid, crop 448x448 tiles row-major, optionally append a
    whole-image thumbnail (reference:
    vita/util/data_utils_video_audio_neg_patch.py:1197-1255).

  - ``dynamic_tile_framecat`` — frameCat variant: grid dims rounded up to
    even, image padded with the mean color, then per 2x2 super-tile emit
    [big(downscaled 896->448), tl, tr, bl, br] — multiples of 5
    (reference: ...neg_frameCat.py:1231-1303).

Numpy in/out ([H, W, 3] uint8). PIL is used only for resizing (bicubic,
matching PIL Image.resize semantics the reference relies on).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# InternViT-300M-448px preprocessing stats (ImageNet).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _resize(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size_wh))


def candidate_grids(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    grids = {
        (i, j)
        for n in range(min_num, max_num + 1)
        for i in range(1, n + 1)
        for j in range(1, n + 1)
        if min_num <= i * j <= max_num
    }
    return sorted(grids, key=lambda x: x[0] * x[1])


def closest_grid(
    width: int, height: int, grids: Sequence[Tuple[int, int]], tile: int
) -> Tuple[int, int]:
    """Reference tie-break: equal ratio-diff prefers the later grid if the
    source image has more area than half the grid's pixel budget."""
    aspect = width / height
    best, best_diff = (1, 1), float("inf")
    area = width * height
    for g in grids:
        diff = abs(aspect - g[0] / g[1])
        if diff < best_diff:
            best_diff, best = diff, g
        elif diff == best_diff and area > 0.5 * tile * tile * g[0] * g[1]:
            best = g
    return best


def dynamic_tile(
    image: np.ndarray,
    min_num: int = 1,
    max_num: int = 12,
    tile: int = 448,
    use_thumbnail: bool = True,
) -> List[np.ndarray]:
    """[H, W, 3] -> list of [tile, tile, 3] crops (+thumbnail if >1 tile)."""
    h, w = image.shape[:2]
    cols, rows = closest_grid(w, h, candidate_grids(min_num, max_num), tile)
    resized = _resize(image, (cols * tile, rows * tile))
    tiles = [
        resized[r * tile : (r + 1) * tile, c * tile : (c + 1) * tile]
        for r in range(rows)
        for c in range(cols)
    ]
    if use_thumbnail and len(tiles) != 1:
        tiles.append(_resize(image, (tile, tile)))
    return tiles


def dynamic_tile_framecat(
    image: np.ndarray,
    min_num: int = 1,
    max_num: int = 12,
    tile: int = 448,
    mean_color: Tuple[float, float, float] = IMAGENET_MEAN,
) -> List[np.ndarray]:
    """frameCat tiling: per 2x2 super-tile [big, tl, tr, bl, br]; len % 5 == 0."""
    h, w = image.shape[:2]
    cols, rows = closest_grid(w, h, candidate_grids(min_num, max_num), tile)
    resized = _resize(image, (cols * tile, rows * tile))

    ecols = cols + (cols % 2)
    erows = rows + (rows % 2)
    pad_color = np.array([int(c * 255) for c in mean_color], resized.dtype)
    canvas = np.broadcast_to(pad_color, (erows * tile, ecols * tile, 3)).copy()
    # expand2even pastes the resized image at the top-left corner
    # (...neg_frameCat.py:1306-1309)
    canvas[: rows * tile, : cols * tile] = resized

    out: List[np.ndarray] = []
    big = tile * 2
    for i in range((ecols // 2) * (erows // 2)):
        bx = (i % (ecols // 2)) * big
        by = (i // (ecols // 2)) * big
        super_tile = canvas[by : by + big, bx : bx + big]
        out.append(_resize(super_tile, (tile, tile)))
        for j in range(4):
            sx, sy = (j % 2) * tile, (j // 2) * tile
            out.append(super_tile[sy : sy + tile, sx : sx + tile])
    assert len(out) % 5 == 0
    return out


def normalize(
    tiles: Sequence[np.ndarray],
    mean: Tuple[float, float, float] = IMAGENET_MEAN,
    std: Tuple[float, float, float] = IMAGENET_STD,
) -> np.ndarray:
    """uint8 tiles -> float32 [N, H, W, 3] normalized pixels."""
    x = np.stack(tiles).astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def sample_video_frames_framecat(
    num_frames_available: int,
    fps: float,
    max_frames: int = 16,
    min_frames: int = 4,
) -> np.ndarray:
    """frameCat frame-index sampling (...neg_frameCat.py:483-498): frame
    COUNT comes from 1 fps coverage rounded up to a multiple of 4 (capped
    at floor(max/4)*4); POSITIONS are taken uniformly from the 3 fps grid."""
    stride_1fps = max(int(round(float(fps) / 1.0)), 1)
    n_1fps = len(range(0, num_frames_available, stride_1fps))
    num = -(-max(n_1fps, 1) // 4) * 4
    num = min(num, (max_frames // 4) * 4)
    num = max(num, min(min_frames, 4))

    stride_3fps = max(int(round(float(fps) / 3.0)), 1)
    grid = np.arange(0, num_frames_available, stride_3fps)
    picks = np.linspace(0, len(grid) - 1, num=num).astype(np.int64)
    return grid[picks]


def assemble_framecat_frames(frames: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Group video frames into frameCat 5-tuples: every 4 consecutive
    frames produce [2x2-mosaic, f1, f2, f3, f4]
    (...neg_frameCat.py:499-519). Frames must share one square size; the
    mosaic is resized back to that size. len(result) % 5 == 0."""
    if len(frames) % 4:
        raise ValueError(f"framecat needs a multiple of 4 frames, got {len(frames)}")
    h, w = frames[0].shape[:2]
    out: List[np.ndarray] = []
    for i in range(0, len(frames), 4):
        quad = frames[i : i + 4]
        canvas = np.empty((2 * h, 2 * w, 3), frames[0].dtype)
        canvas[:h, :w] = quad[0]
        canvas[:h, w:] = quad[1]
        canvas[h:, :w] = quad[2]
        canvas[h:, w:] = quad[3]
        out.append(_resize(canvas, (w, h)))
        out.extend(quad)
    assert len(out) % 5 == 0
    return out


def sample_video_frames(
    num_frames_available: int,
    fps: float,
    sample_fps: float = 1.0,
    max_frames: int = 16,
    min_frames: int = 4,
) -> np.ndarray:
    """Uniform frame-index sampling like the demo decoder
    (video_audio_demo.py:30-118): sample at ``sample_fps``, clamp count to
    [min_frames, max_frames] with uniform re-spacing."""
    duration = num_frames_available / max(fps, 1e-6)
    n = int(duration * sample_fps)
    n = max(min(n, max_frames), min(min_frames, num_frames_available))
    n = max(n, 1)
    return np.linspace(0, num_frames_available - 1, n).round().astype(np.int64)
