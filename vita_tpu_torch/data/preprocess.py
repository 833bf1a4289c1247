"""Training-sample preprocessing: media-token normalization, state tokens,
prompt building, and target masking (a copy of vita_tpu.data.preprocess, so
that the port loads no module of the reference package;
tests/test_torch_data.py holds it equal to the original).

Behavior parity with the reference's active pipeline
(vita/util/data_utils_video_audio_neg_frameCat.py):

  - ``normalize_media_tokens`` == preprocess_multimodal (:44-132): trailing
    ``<image>`` runs move to the front, video frame counts clamp to
    MAX_IMAGE_LENGTH, ``<image>`` expands to the per-image patch count,
    and every assistant turn gets a state token — ``<2>`` at the injected
    negative-sample turn, ``<1>`` after an audio query, ``<3>`` otherwise
    (:119-126).

  - ``build_training_sample`` == preprocess_mixtral_two (:261-387): renders
    the mixtral_two prompt, tokenizes with media sentinels, then masks
    labels so only assistant responses (state token + text + ``</s>``)
    train. The masking reproduces the reference's round-split arithmetic
    exactly — including its tokenization-mismatch fallback that IGNOREs the
    whole sample and warns (:376-382).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vita_tpu_torch.constants import (
    DEFAULT_AUDIO_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    MAX_IMAGE_LENGTH,
    STATE_TOKEN_AUDIO,
    STATE_TOKEN_NOISY,
    STATE_TOKEN_TEXT,
)
from vita_tpu_torch.constants import MIXTRAL_TWO
from vita_tpu_torch.tokenization import tokenize_multimodal

Turn = Dict[str, str]  # {"from": "human"|"gpt", "value": str}


def _front_load(text: str, token: str) -> str:
    """If text ends with a run of `token`, move the run to the front.

    NOTE: newline-adjacency stripping is NOT done here — the reference
    normalizes newlines around DEFAULT_IMAGE_TOKEN only (neg_frameCat.py
    :61-71), never around the video token; callers do that separately."""
    if text.endswith(token):
        n = text.count(token)
        text = text.replace(token * n, "").strip()
        text = (token * n + text).strip()
    return text


def normalize_media_tokens(
    turns: Sequence[Turn],
    image_token_num: int = 1,
    patch_nums: Sequence[int] = (1,),
    inserted_id: Optional[int] = None,
) -> List[Turn]:
    """Returns new turns with media tokens normalized and state tokens added."""
    turns = copy.deepcopy(list(turns))
    k_img = 0
    for i, t in enumerate(turns):
        v = t["value"]
        if DEFAULT_IMAGE_TOKEN in v or DEFAULT_VIDEO_TOKEN in v:
            # newline normalization applies to the IMAGE token only
            # (reference neg_frameCat.py:61-71); '\n<video>' stays intact
            v = v.replace(DEFAULT_IMAGE_TOKEN + "\n", DEFAULT_IMAGE_TOKEN).strip()
            v = v.replace("\n" + DEFAULT_IMAGE_TOKEN, DEFAULT_IMAGE_TOKEN).strip()
            v = _front_load(v, DEFAULT_IMAGE_TOKEN)
            v = _front_load(v, DEFAULT_VIDEO_TOKEN)
            n_img = v.count(DEFAULT_IMAGE_TOKEN)
            if n_img > MAX_IMAGE_LENGTH:
                v = v.replace(
                    DEFAULT_IMAGE_TOKEN * n_img, DEFAULT_IMAGE_TOKEN * MAX_IMAGE_LENGTH
                ).strip()
        if DEFAULT_IMAGE_TOKEN in v:
            if k_img >= len(patch_nums):
                raise ValueError("more <image> turns than patch_nums entries")
            rep = DEFAULT_IMAGE_TOKEN * patch_nums[k_img]
            k_img += 1
        else:
            rep = DEFAULT_IMAGE_TOKEN
        v = v.replace(DEFAULT_IMAGE_TOKEN, rep + "\n")
        v = v.replace(DEFAULT_VIDEO_TOKEN, DEFAULT_IMAGE_TOKEN * image_token_num + "\n")
        v = v.replace(DEFAULT_AUDIO_TOKEN + "\n", DEFAULT_AUDIO_TOKEN)
        v = v.replace("\n\n", "\n")

        if i == inserted_id:
            if t["from"] != "gpt":
                raise ValueError("inserted_id must point at an assistant turn")
            v = STATE_TOKEN_NOISY + v
        elif t["from"] == "gpt":
            prev = turns[i - 1]["value"] if i > 0 else ""
            v = (STATE_TOKEN_AUDIO if DEFAULT_AUDIO_TOKEN in prev else STATE_TOKEN_TEXT) + v
        t["value"] = v
    return turns


def render_conversation(turns: Sequence[Turn], modality: str) -> str:
    """Build the mixtral_two prompt string for a full training conversation."""
    role_map = {"human": MIXTRAL_TWO.roles[0], "gpt": MIXTRAL_TWO.roles[1]}
    turns = list(turns)
    if turns and role_map.get(turns[0]["from"]) != MIXTRAL_TWO.roles[0]:
        turns = turns[1:]  # skip a leading assistant turn
    msgs = []
    for j, t in enumerate(turns):
        role = role_map[t["from"]]
        expected = MIXTRAL_TWO.roles[j % 2]
        if role != expected:
            raise ValueError(f"turn {j}: role {role!r}, expected {expected!r}")
        msgs.append((role, t["value"]))
    return MIXTRAL_TWO.render(msgs, modality)


def build_training_sample(
    turns: Sequence[Turn],
    encode: Callable[[str], List[int]],
    modality: str,
    has_media: bool,
    bos_id: int,
    eos_id: int,
    pad_id: Optional[int] = None,
    model_max_length: int = 8192,
    end_tag: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (input_ids, labels) with reference-exact target masking."""
    conversation = render_conversation(turns, modality)
    if not end_tag:
        conversation = conversation[: -len(MIXTRAL_TWO.sep)]

    def tok(s: str) -> List[int]:
        if has_media:
            return tokenize_multimodal(s, encode, bos_id=bos_id)
        return encode(s)

    ids = tok(conversation)
    if not has_media:
        ids = ids[:model_max_length]
    input_ids = np.asarray(ids, np.int64)
    target = input_ids.copy()
    pad_id = eos_id if pad_id is None else pad_id

    sep = MIXTRAL_TWO.sep + "\n" + MIXTRAL_TWO.roles[1] + ":"  # "</s>\nbot:"
    sep2_2 = "\n" + MIXTRAL_TWO.roles[0] + ":"  # "\nuser:"
    sep2 = MIXTRAL_TWO.sep2 + sep2_2  # "</s>\nuser:"

    total_len = int((input_ids != pad_id).sum())
    rounds = conversation.split(sep2)
    rounds = [rounds[0] + sep2 + rounds[1]] + rounds[2:] if len(rounds) > 1 else rounds
    cur_len = 1
    end_token_cnt = 0
    target[:cur_len] = IGNORE_INDEX

    for i, rou in enumerate(rounds):
        if rou == "":
            break
        if i > 0:
            rou = sep2_2 + rou
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep
        if has_media:
            round_len = len(tok(rou))
            instruction_len = len(tok(parts[0])) - 1
        else:
            round_len = len(encode(rou))
            instruction_len = len(encode(parts[0])) - 2
        target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
        end_token_cnt += 1
        cur_len += round_len

    cur_len -= 1
    target[cur_len:] = IGNORE_INDEX
    if pad_id == eos_id:
        cur_len -= end_token_cnt
    if cur_len < model_max_length and cur_len != total_len:
        target[:] = IGNORE_INDEX
        print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")

    return input_ids, target
