"""The host-side helpers of vita_tpu.tokenization that the port runs: media
sentinels and their expansion (prompt building), prompt buckets and audio
slot addressing (serving).

They are copied rather than imported so that the port loads no module of
the reference package; tests/test_torch_engine.py and
tests/test_torch_generate.py hold them equal to the originals.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from vita_tpu_torch.constants import AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX

_MEDIA_SPLIT = re.compile(r"(<audio>|<image>)")


def tokenize_multimodal(prompt: str, encode: Callable[[str], List[int]],
                        bos_id: Optional[int] = None) -> List[int]:
    """Tokenize a prompt, splicing one sentinel id per ``<image>`` /
    ``<audio>`` placeholder. When ``encode`` starts the first chunk with
    ``bos_id``, one BOS is kept at position 0 and every chunk's own is
    stripped."""
    sentinel = {"<image>": IMAGE_TOKEN_INDEX, "<audio>": AUDIO_TOKEN_INDEX}
    chunks = [[sentinel[p]] if p in sentinel else encode(p) for p in _MEDIA_SPLIT.split(prompt)]
    ids: List[int] = []
    offset = 0
    if bos_id is not None and chunks and chunks[0] and chunks[0][0] == bos_id:
        offset = 1
        ids.append(bos_id)
    for c in chunks:
        ids.extend(c if c in ([IMAGE_TOKEN_INDEX], [AUDIO_TOKEN_INDEX]) else c[offset:])
    return ids


def expand_media_sentinels(ids: Sequence[int], image_slot_counts: Sequence[int] = (),
                           audio_slot_counts: Sequence[int] = ()) -> List[int]:
    """Each media sentinel repeated as many times as its item has feature
    rows (``image_slot_counts[k]`` for the k-th image sentinel, likewise
    for audio), so the on-device merge has static shapes."""
    out: List[int] = []
    used = {IMAGE_TOKEN_INDEX: 0, AUDIO_TOKEN_INDEX: 0}
    counts = {IMAGE_TOKEN_INDEX: image_slot_counts, AUDIO_TOKEN_INDEX: audio_slot_counts}
    names = {IMAGE_TOKEN_INDEX: "image", AUDIO_TOKEN_INDEX: "audio"}
    for tok in ids:
        if tok in counts:
            i = used[tok]
            if i >= len(counts[tok]):
                raise ValueError(f"more <{names[tok]}> sentinels than "
                                 f"{names[tok]}_slot_counts entries")
            out.extend([tok] * counts[tok][i])
            used[tok] = i + 1
        else:
            out.append(int(tok))
    for tok, n in counts.items():
        if used[tok] != len(n):
            raise ValueError(f"{len(n) - used[tok]} unused {names[tok]}_slot_counts entries")
    return out


def media_masks(expanded_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids with sentinels replaced by 0, image mask, audio mask)."""
    expanded_ids = np.asarray(expanded_ids)
    image_mask = expanded_ids == IMAGE_TOKEN_INDEX
    audio_mask = expanded_ids == AUDIO_TOKEN_INDEX
    return np.where(image_mask | audio_mask, 0, expanded_ids), image_mask, audio_mask


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
