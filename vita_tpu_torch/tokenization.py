"""The three host-side helpers the serving path itself needs, from
vita_tpu.tokenization (prompt buckets and audio slot addressing).

They are copied rather than imported so that serving on the card loads no
module of the reference package; tests/test_torch_engine.py holds them
equal to the originals. Prompt building and tokenization stay in
vita_tpu (tokenization, conversation, cli.ByteTokenizer), which callers use
before they build a Request.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def audio_token_count(num_frames: int) -> int:
    """LLM tokens produced by a fbank clip of ``num_frames`` 10 ms frames:
    Conv2dSubsampling4 then the adapter's stride-2 conv."""
    downsampled = ((num_frames - 1) // 2 - 1) // 2
    return (downsampled - 1) // 2 + 1


def pad_to_bucket(ids: Sequence[int], buckets: Sequence[int],
                  pad_id: int) -> Tuple[List[int], int]:
    """Right-pad ``ids`` to the smallest bucket >= len(ids). Returns
    (padded_ids, true_len); raises past the largest bucket."""
    n = len(ids)
    for b in sorted(buckets):
        if n <= b:
            return list(ids) + [pad_id] * (b - n), n
    raise ValueError(f"sequence length {n} exceeds largest bucket {max(buckets)}")


def audio_select_arrays(
    audio_mask: np.ndarray,  # [S] bool — expanded audio slot positions
    audio_slot_counts: Sequence[int],  # LLM tokens per clip, in clip order
) -> Tuple[np.ndarray, np.ndarray]:
    """(clip_idx [S], row_idx [S]): which clip and feature row every audio
    slot reads."""
    positions = np.flatnonzero(audio_mask)
    if positions.size != sum(audio_slot_counts):
        raise ValueError(
            f"audio mask has {positions.size} slots but clips provide "
            f"{sum(audio_slot_counts)}"
        )
    clip = np.zeros(len(audio_mask), np.int32)
    row = np.zeros(len(audio_mask), np.int32)
    clip[positions] = np.repeat(np.arange(len(audio_slot_counts)), audio_slot_counts)
    row[positions] = np.concatenate(
        [np.arange(n) for n in audio_slot_counts] or [np.zeros(0, np.int64)]
    )
    return clip, row
