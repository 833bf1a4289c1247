"""Conversation protocol: prompt templates with per-modality system prompts.

Behavior parity with the reference's conversation layer (reference:
vita/conversation.py:30-105,229-242) — rendered prompt strings are
byte-identical for the same message history — but the design here is
immutable/functional: a `ConversationTemplate` is frozen; message history
lives in a plain list the caller owns; rendering is a pure function. (The
reference mutates `self.system` inside `get_prompt`, which makes template
objects single-use per modality; we avoid that.)

A copy of vita_tpu.conversation, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from vita_tpu_torch.constants import DEFAULT_IMAGE_TOKEN

Message = Tuple[str, str]  # (role, text); text == "" means "cue the role"


@dataclasses.dataclass(frozen=True)
class ConversationTemplate:
    """A frozen prompt template.

    ``system`` is a tuple of system prompts. For ``style='mixtral_two'`` it
    holds (image, video, lang) variants selected by the query modality
    (reference: vita/conversation.py:65-90); other styles use system[0].
    """

    name: str
    system: Tuple[str, ...]
    roles: Tuple[str, str]
    style: str  # 'mixtral_two' | 'mixtral_zh' | 'two' | 'plain'
    sep: str = "###"
    sep2: str = ""

    def system_for(self, modality: str) -> str:
        if self.style != "mixtral_two":
            return self.system[0]
        idx = {"image": 0, "video": 1, "lang": 2}.get(modality)
        if idx is None:
            raise ValueError(f"unknown modality {modality!r}")
        return self.system[idx]

    def render(self, messages: Sequence[Message], modality: str = "lang") -> str:
        """Render the full prompt string for a message history.

        For mixtral_two the modality must be consistent with the content:
        a history containing ``<image>`` requires modality image/video, and
        a text-only history requires 'lang' (reference:
        vita/conversation.py:67-82).
        """
        seps = (self.sep, self.sep2 or self.sep)

        if self.style in ("mixtral_two", "mixtral_zh"):
            if self.style == "mixtral_two":
                has_image = any(m and DEFAULT_IMAGE_TOKEN in m for _, m in messages)
                if has_image and modality not in ("image", "video"):
                    raise ValueError("history contains <image> but modality is not image/video")
                if not has_image and modality != "lang":
                    raise ValueError("text-only history requires modality='lang'")
            out = ["system:", self.system_for(modality), seps[0]]
            for i, (role, text) in enumerate(messages):
                if text:
                    out += ["\n", role, ":", text, seps[i % 2]]
                else:
                    out += ["\n", role, ":"]
            return "".join(out)

        if self.style == "two":
            out = [self.system[0], seps[0]]
            for i, (role, text) in enumerate(messages):
                if text:
                    out += [role, ": ", text, seps[i % 2]]
                else:
                    out += [role, ":"]
            return "".join(out)

        if self.style == "plain":
            out = [self.system[0]]
            for i, (_, text) in enumerate(messages):
                if text:
                    out += [text, seps[i % 2]]
            return "".join(out)

        raise ValueError(f"unknown style {self.style!r}")


class Dialog:
    """Mutable message-history helper around a frozen template."""

    def __init__(self, template: ConversationTemplate):
        self.template = template
        self.messages: List[Message] = []

    def add(self, role: str, text: str) -> "Dialog":
        self.messages.append((role, text))
        return self

    def user(self, text: str) -> "Dialog":
        return self.add(self.template.roles[0], text)

    def assistant(self, text: str = "") -> "Dialog":
        return self.add(self.template.roles[1], text)

    def render(self, modality: str = "lang") -> str:
        return self.template.render(self.messages, modality)


_VITA_SYSTEM_COMMON = (
    "You are an AI robot and your name is VITA. \n"
    "- You are a multimodal large language model developed by the open source"
    " community. Your aim is to be helpful, honest and harmless. \n"
    "- You support the ability to communicate fluently and answer user"
    " questions in multiple languages of the user's choice. \n"
    "- If the user corrects the wrong answer you generated, you will apologize"
    " and discuss the correct answer with the user."
)

_VITA_SYSTEM_IMAGE = _VITA_SYSTEM_COMMON + (
    " \n- You must answer the question strictly according to the content of"
    " the image given by the user, and it is strictly forbidden to answer the"
    " question without the content of the image. Please note that you are"
    " seeing the image, not the video."
)

_VITA_SYSTEM_VIDEO = _VITA_SYSTEM_COMMON + (
    " \n- You must answer the question strictly according to the content of"
    " the video given by the user, and it is strictly forbidden to answer the"
    " question without the content of the video. Please note that you are"
    " seeing the video, not the image."
)

MIXTRAL_TWO = ConversationTemplate(
    name="mixtral_two",
    system=(_VITA_SYSTEM_IMAGE, _VITA_SYSTEM_VIDEO, _VITA_SYSTEM_COMMON),
    roles=("user", "bot"),
    style="mixtral_two",
    sep="</s>",
    sep2="</s>",
)

MIXTRAL_ZH = ConversationTemplate(
    name="mixtral_zh",
    system=(
        "你是一个人工智能机器人。\n- 你是研究社区开发的大语言模型。"
        "你的设计宗旨是有益、诚实且无害。\n- 你支持使用用户选择的多种语言流利地"
        "进行交流并解答用户的问题。\n- 如果用户更正你生成的错误答案，"
        "你会向用户致歉并与用户探讨正确的答案。",
    ),
    roles=("user", "bot"),
    style="mixtral_zh",
    sep="</s>",
    sep2="</s>",
)

PLAIN = ConversationTemplate(
    name="plain",
    system=("",),
    roles=("", ""),
    style="plain",
    sep="\n",
    sep2="\n",
)

TEMPLATES = {
    "default": MIXTRAL_TWO,
    "mixtral_two": MIXTRAL_TWO,
    "mixtral_zh": MIXTRAL_ZH,
    "plain": PLAIN,
}
