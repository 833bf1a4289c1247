"""The constants and the mixtral_two conversation template the port's host
code needs (vita_tpu.constants, vita_tpu.conversation.MIXTRAL_TWO).

They are copied rather than imported so that the port loads no module of
the reference package; tests/test_torch_data.py holds them equal to the
originals.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# video frame-count limits
MAX_IMAGE_LENGTH = 16
MIN_IMAGE_LENGTH = 4

# label id that the loss ignores
IGNORE_INDEX = -100

# sentinel ids spliced into prompts at media placeholders
IMAGE_TOKEN_INDEX = -200
AUDIO_TOKEN_INDEX = -500

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_AUDIO_TOKEN = "<audio>"

# interaction state tokens prepended to assistant turns in training:
# answer the audio query, noisy audio (do not reply), answer the text query
STATE_TOKEN_AUDIO = "<1>"
STATE_TOKEN_NOISY = "<2>"
STATE_TOKEN_TEXT = "<3>"

# visual tokens per 448x448 tile after pixel-shuffle x0.5
IMAGE_TOKENS_PER_PATCH = 256

Message = Tuple[str, str]  # (role, text); text == "" cues the role

_SYSTEM_LANG = (
    "You are an AI robot and your name is VITA. \n"
    "- You are a multimodal large language model developed by the open source"
    " community. Your aim is to be helpful, honest and harmless. \n"
    "- You support the ability to communicate fluently and answer user"
    " questions in multiple languages of the user's choice. \n"
    "- If the user corrects the wrong answer you generated, you will apologize"
    " and discuss the correct answer with the user."
)


def _system_media(m: str, other: str) -> str:
    return _SYSTEM_LANG + (
        " \n- You must answer the question strictly according to the content of"
        f" the {m} given by the user, and it is strictly forbidden to answer the"
        f" question without the content of the {m}. Please note that you are"
        f" seeing the {m}, not the {other}.")


@dataclasses.dataclass(frozen=True)
class MixtralTwoTemplate:
    """The mixtral_two prompt template: a system prompt chosen by the
    query's modality, then ``role:text`` turns each closed by ``sep``."""

    system: Tuple[str, str, str] = (_system_media("image", "video"),
                                    _system_media("video", "image"), _SYSTEM_LANG)
    roles: Tuple[str, str] = ("user", "bot")
    sep: str = "</s>"
    sep2: str = "</s>"

    def render(self, messages: Sequence[Message], modality: str = "lang") -> str:
        """The prompt for a message history; a history with ``<image>``
        needs modality image or video, a text-only one 'lang'."""
        idx = {"image": 0, "video": 1, "lang": 2}.get(modality)
        if idx is None:
            raise ValueError(f"unknown modality {modality!r}")
        has_image = any(m and DEFAULT_IMAGE_TOKEN in m for _, m in messages)
        if has_image and modality not in ("image", "video"):
            raise ValueError("history contains <image> but modality is not image/video")
        if not has_image and modality != "lang":
            raise ValueError("text-only history requires modality='lang'")
        seps = (self.sep, self.sep2)
        out = ["system:", self.system[idx], seps[0]]
        for i, (role, text) in enumerate(messages):
            out += ["\n", role, ":", text, seps[i % 2]] if text else ["\n", role, ":"]
        return "".join(out)


MIXTRAL_TWO = MixtralTwoTemplate()
