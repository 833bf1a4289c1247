"""Multi-turn chat history: replay + the interactive demo's merge rules.

Two reference behaviors, one shared helper:

- **History replay** (basic web demo, web_demo/web_ability_demo.py:132-243):
  every past (user, bot) turn re-renders through the conversation template,
  media placeholders and all; noise-rejected (`<2>`) turns are dropped.
- **Interactive merge** (web_demo/web_interactive_demo.py:604-680
  merge_current_and_history): optionally strip vision placeholders from
  history (``skip_history_vision``) and move every remaining ``<image>``
  token to the front of the first user message
  (``image_tokens_to_front``), keeping their relative order.

Media tensors ride along per turn; ``merged.media()`` returns them in
sentinel order so the expanded prompt's slot counts line up exactly.

A copy of vita_tpu.serve.history, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vita_tpu_torch.constants import (
    DEFAULT_AUDIO_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
)
from vita_tpu_torch.conversation import TEMPLATES, Dialog


@dataclasses.dataclass
class HistoryTurn:
    prompt: str  # user text, WITH media placeholders
    response: str
    # media for this turn's placeholders, in placeholder order
    images: Optional[np.ndarray] = None  # [N_tiles, H, W, 3] normalized
    image_slot_counts: Tuple[int, ...] = ()  # LLM slots per <image> sentinel
    speech: Optional[np.ndarray] = None  # [T, 80]
    speech_length: int = 0
    # streaming-path alternative to ``speech``: Whale encoder output
    # [T', whale_hidden] captured live (serve.streaming_audio). A session
    # should use one representation consistently — raw fbank XOR encoded.
    encoded: Optional[np.ndarray] = None
    encoded_length: int = 0

    @property
    def rejected_noise(self) -> bool:
        return self.response.startswith("<2>")


@dataclasses.dataclass
class MergedPrompt:
    prompt: str
    modality: str
    images: Optional[np.ndarray]
    image_slot_counts: Tuple[int, ...]
    speeches: List[np.ndarray]
    speech_lengths: List[int]
    encodeds: List[np.ndarray] = dataclasses.field(default_factory=list)
    encoded_lengths: List[int] = dataclasses.field(default_factory=list)


def _strip_vision(text: str) -> str:
    return text.replace(DEFAULT_IMAGE_TOKEN, "").replace(DEFAULT_VIDEO_TOKEN, "")


def merge_current_and_history(
    history: Sequence[HistoryTurn],
    prompt: str,
    images: Optional[np.ndarray] = None,
    image_slot_counts: Sequence[int] = (),
    speech: Optional[np.ndarray] = None,
    speech_length: int = 0,
    encoded: Optional[np.ndarray] = None,
    encoded_length: int = 0,
    skip_history_vision: bool = False,
    image_tokens_to_front: bool = False,
    template: str = "mixtral_two",
    drop_noise_turns: bool = True,
) -> MergedPrompt:
    """Build the full multi-turn prompt + merged media for a new request.

    Reference semantics (web_interactive_demo.py:604-680): history turns
    concatenate as user/bot rounds under one system prompt; vision history
    optionally drops (placeholders AND tensors); with
    ``image_tokens_to_front`` every surviving <image> moves to the start of
    the first user message (relative order preserved). The modality follows
    the interactive demo's rule: any image/video content selects the video
    system prompt, else audio/lang (:617-625, where image also maps to the
    video prompt)."""
    turns: List[Tuple[str, str]] = []  # (user_text, bot_text)
    image_arrays: List[np.ndarray] = []
    slot_counts: List[int] = []
    speeches: List[np.ndarray] = []
    speech_lengths: List[int] = []
    encodeds: List[np.ndarray] = []
    encoded_lengths: List[int] = []

    for h in history:
        if drop_noise_turns and h.rejected_noise:
            # the ability demo skips <2>-rejected rounds on replay
            # (web_ability_demo.py:148-150)
            continue
        text = _strip_vision(h.prompt) if skip_history_vision else h.prompt
        turns.append((text.strip() or text, h.response))
        if not skip_history_vision and h.images is not None:
            image_arrays.append(h.images)
            slot_counts.extend(h.image_slot_counts)
        if h.speech is not None:
            speeches.append(h.speech)
            speech_lengths.append(h.speech_length)
        elif h.encoded is not None:
            encodeds.append(h.encoded)
            encoded_lengths.append(h.encoded_length)

    turns.append((prompt, ""))
    if images is not None:
        image_arrays.append(images)
        slot_counts.extend(image_slot_counts)
    if speech is not None:
        speeches.append(speech)
        speech_lengths.append(speech_length)
    elif encoded is not None:
        encodeds.append(encoded)
        encoded_lengths.append(encoded_length)

    if image_tokens_to_front and turns:
        n_img = sum(t.count(DEFAULT_IMAGE_TOKEN) for t, _ in turns)
        stripped = [(u.replace(DEFAULT_IMAGE_TOKEN, ""), b) for u, b in turns]
        first_u, first_b = stripped[0]
        turns = [(DEFAULT_IMAGE_TOKEN * n_img + first_u, first_b)] + stripped[1:]

    # any image OR video media selects the video system prompt (reference
    # maps both to system_prompts['video'], web_interactive_demo.py:619-622)
    has_image = any(
        DEFAULT_IMAGE_TOKEN in u or DEFAULT_VIDEO_TOKEN in u for u, _ in turns
    )
    modality = "video" if has_image else "lang"

    d = Dialog(TEMPLATES[template])
    for u, b in turns[:-1]:
        d.user(u)
        d.assistant(b)
    d.user(turns[-1][0])
    d.assistant()

    merged_images = (
        np.concatenate(image_arrays, axis=0) if image_arrays else None
    )
    return MergedPrompt(
        prompt=d.render(modality),
        modality=modality,
        images=merged_images,
        image_slot_counts=tuple(slot_counts),
        speeches=speeches,
        speech_lengths=speech_lengths,
        encodeds=encodeds,
        encoded_lengths=encoded_lengths,
    )


class ChatSession:
    """Per-session turn store for the HTTP server / demos.

    ``lock`` serializes a session's merge -> generate -> record sequence:
    two concurrent requests with the same session id would otherwise race
    on ``turns`` and build prompts from half-updated history."""

    def __init__(self, limit: int = 10):
        import threading

        self.turns: List[HistoryTurn] = []
        self.limit = limit
        self.lock = threading.Lock()

    def add(self, turn: HistoryTurn) -> None:
        self.turns.append(turn)
        if len(self.turns) > self.limit:
            self.turns = self.turns[-self.limit:]

    def merge(self, prompt: str, **kw) -> MergedPrompt:
        return merge_current_and_history(self.turns, prompt, **kw)
