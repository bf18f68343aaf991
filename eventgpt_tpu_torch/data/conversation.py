"""Conversation templating for event-QA prompts.

Behavioral parity with the reference's ``dataset/conversation.py``: the
``eventgpt_v1`` template is Vicuna-v1 style (two-separator), and
``prepare_event_prompt`` wraps the query with
``<ev_start><event><ev_end>\\n`` (``dataset/conversation.py:212-237``).

This is a clean reimplementation: prompt assembly only (strings in, strings
out). The reference's gradio/base64 image helpers serve an unshipped web UI
and are intentionally out of scope for the framework core.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

from eventgpt_tpu_torch.constants import (
    DEFAULT_EV_END_TOKEN,
    DEFAULT_EV_START_TOKEN,
    DEFAULT_EVENT_TOKEN,
)


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    """An ordered list of (role, message) turns plus a rendering style.

    Module-level templates are frozen with ``messages=()`` (a tuple) so that
    accidental in-place mutation of a template fails loudly; always work on a
    ``.copy()``, which materializes a fresh list.
    """

    system: str
    roles: Tuple[str, str]
    messages: Sequence[Sequence[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "unknown"

    def append_message(self, role: str, message: Optional[str]) -> None:
        if not isinstance(self.messages, list):
            raise TypeError(
                "cannot append to a frozen conversation template; use .copy() first"
            )
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            out = [self.system, self.sep]
            for role, msg in self.messages:
                out.append(f"{role}: {msg}{self.sep}" if msg else f"{role}:")
            return "".join(out)
        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = [self.system, seps[0]]
            for i, (role, msg) in enumerate(self.messages):
                out.append(f"{role}: {msg}{seps[i % 2]}" if msg else f"{role}:")
            return "".join(out)
        if style == SeparatorStyle.MPT:
            out = [self.system, self.sep]
            for role, msg in self.messages:
                out.append(f"{role}{msg}{self.sep}" if msg else role)
            return "".join(out)
        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = [self.system]
            for i, (_, msg) in enumerate(self.messages):
                out.append(f"{msg}{seps[i % 2]}" if msg else "")
            return "".join(out)
        if style == SeparatorStyle.LLAMA_2:
            def wrap_sys(m: str) -> str:
                return f"<<SYS>>\n{m}\n<</SYS>>\n\n" if m else m

            out = []
            for i, (role, msg) in enumerate(self.messages):
                if i == 0:
                    if not msg:
                        raise ValueError("first message must be non-empty")
                    if role != self.roles[0]:
                        raise ValueError("first message must come from the user role")
                if not msg:
                    continue
                if i == 0:
                    msg = wrap_sys(self.system) + msg
                if i % 2 == 0:
                    out.append(f"{self.sep}[INST] {msg} [/INST]")
                else:
                    out.append(f" {msg} {self.sep2}")
            return "".join(out).lstrip(self.sep)
        raise ValueError(f"Invalid separator style: {style}")

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def to_dict(self) -> dict:
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": self.messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


conv_eventgpt_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=(),
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

# Plain style used by the pretraining alignment stage (projector warm-up):
# bare "<event>\ncaption</s>" pairs, mirroring LLaVA's "plain" conversation
# version referenced by preprocess_plain in the training pyc (SURVEY.md §2.2).
conv_eventgpt_plain = Conversation(
    system="",
    roles=("", ""),
    messages=(),
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="</s>",
    version="plain",
)

default_conversation = conv_eventgpt_v1
conv_templates = {
    "eventgpt_v1": conv_eventgpt_v1,
    "eventgpt_plain": conv_eventgpt_plain,
}


def prepare_event_prompt(query: str, conv_mode: str = "eventgpt_v1") -> str:
    """Render a single-turn event-QA prompt.

    Parity: ``dataset/conversation.py:229-237`` — the query is prefixed with
    ``<ev_start><event><ev_end>\\n`` and rendered with an empty assistant turn.
    """
    qs = DEFAULT_EV_START_TOKEN + DEFAULT_EVENT_TOKEN + DEFAULT_EV_END_TOKEN + "\n" + query
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def render_multiturn(turns: Sequence[Tuple[str, str]], conv_mode: str = "eventgpt_v1") -> str:
    """Render a full multi-turn conversation (training-time prompt assembly)."""
    conv = conv_templates[conv_mode].copy()
    for role, msg in turns:
        conv.append_message(role, msg)
    return conv.get_prompt()
