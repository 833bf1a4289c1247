"""Shape buckets and clip stacking for the serving engine
(vita_tpu.generate). The Generator class is not ported yet.

Prompts, image tiles and audio frames pad to fixed buckets, as in the JAX
package, so both engines see the same padded shapes and the same prefill
chunking.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from vita_tpu_torch.models.whale import subsampled_length
from vita_tpu_torch.tokenization import audio_token_count

DEFAULT_PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
DEFAULT_TILE_BUCKETS = (1, 5, 13)  # dynamic-patch counts: 1 tile .. 12+thumbnail
DEFAULT_FRAME_BUCKETS = (400, 800, 1600, 3200, 6400)  # 10ms fbank frames
CLIP_COUNT_BUCKETS = (1, 2, 4, 8, 16)


def pad_axis0(x: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Zero-pad axis 0 of ``x`` up to the smallest bucket >= its length.
    Lengths beyond the largest bucket are left as they are."""
    n = x.shape[0]
    for b in sorted(buckets):
        if n <= b:
            return x if n == b else np.pad(x, [(0, b - n)] + [(0, 0)] * (x.ndim - 1))
    return x


def _stack_clips(clips, lens: List[int], buckets: Sequence[int]):
    """Pad each clip to its bucket, then to the longest, then the clip
    count to its bucket (padding clips have length 1 and are never
    selected by the merge)."""
    padded = [pad_axis0(np.asarray(c, np.float32), buckets) for c in clips]
    t = max(p.shape[0] for p in padded)
    padded = [np.pad(p, ((0, t - p.shape[0]), (0, 0))) for p in padded]
    nb = next((b for b in CLIP_COUNT_BUCKETS if b >= len(padded)), len(padded))
    while len(padded) < nb:
        padded.append(np.zeros((t, padded[0].shape[1]), np.float32))
        lens.append(1)
    return np.stack(padded), np.asarray(lens, np.int32)


def _clip_lengths(clips, length) -> List[int]:
    if isinstance(length, (list, tuple, np.ndarray)):
        lens = [int(x) for x in length]
    else:
        lens = [int(length or clips[0].shape[0])]
    if len(lens) != len(clips):
        raise ValueError(f"{len(clips)} clips but {len(lens)} lengths")
    return lens


def stack_speech_clips(
    speech, speech_length, frame_buckets: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """One-or-many fbank clips -> (clips [n_bucket, T_bucket, 80], lengths
    [n_bucket], per-clip LLM token counts)."""
    clips = list(speech) if isinstance(speech, (list, tuple)) else [speech]
    lens = _clip_lengths(clips, speech_length)
    counts = [audio_token_count(n) for n in lens]
    stacked, lengths = _stack_clips(clips, lens, frame_buckets)
    return stacked, lengths, counts


def stack_encoded_clips(
    encoded, encoded_length, frame_buckets: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """stack_speech_clips for Whale features encoded ahead of time
    ([T', hidden] clips); buckets are the frame buckets after
    subsampling, token counts the adapter's (T'-1)//2+1."""
    clips = list(encoded) if isinstance(encoded, (list, tuple)) else [encoded]
    lens = _clip_lengths(clips, encoded_length)
    counts = [(n - 1) // 2 + 1 for n in lens]
    sub_buckets = sorted({int(subsampled_length(b)) for b in frame_buckets})
    stacked, lengths = _stack_clips(clips, lens, sub_buckets)
    return stacked, lengths, counts
