"""Tokenization utilities: the ``<event>`` sentinel splice.

Parity with ``common/common.py:43-62`` (``tokenizer_event_token``): the prompt
is split on ``<event>``, each chunk is tokenized independently, and the chunks
are rejoined with the sentinel ``EVENT_TOKEN_INDEX`` (-200) standing in for
the event-feature block. A leading BOS is preserved exactly once.

Works with any object exposing the minimal tokenizer protocol used here:
``__call__(text).input_ids`` (or returning a dict) and ``bos_token_id``.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from eventgpt_tpu_torch.constants import DEFAULT_EVENT_TOKEN, EVENT_TOKEN_INDEX


def _encode(tokenizer: Any, text: str) -> List[int]:
    out = tokenizer(text)
    ids = out["input_ids"] if isinstance(out, dict) else out.input_ids
    return list(ids)


def tokenize_with_event(
    prompt: str,
    tokenizer: Any,
    event_token_index: int = EVENT_TOKEN_INDEX,
) -> List[int]:
    """Tokenize ``prompt``, replacing each ``<event>`` with the sentinel id.

    Exact semantics of the reference (``common/common.py:43-62``): when the
    tokenizer emits BOS at the start of every chunk, the BOS of the first
    chunk is kept and the BOS of subsequent chunks is dropped.
    """
    chunks = [_encode(tokenizer, c) for c in prompt.split(DEFAULT_EVENT_TOKEN)]

    input_ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == getattr(tokenizer, "bos_token_id", None):
        offset = 1
        input_ids.append(chunks[0][0])

    for i, chunk in enumerate(chunks):
        input_ids.extend(chunk[offset:])
        if i < len(chunks) - 1:
            input_ids.append(event_token_index)
    return input_ids


def split_at_event(input_ids: Sequence[int]) -> List[np.ndarray]:
    """Split an id sequence at EVENT_TOKEN_INDEX sentinels (sentinels removed).

    Returns the list of text segments; ``len(segments) == num_events + 1``.
    This is the host-side planning step for the fixed-layout embedding splice
    (the jit-friendly redesign of ``model/EventChatModel.py:292-428``).
    """
    ids = np.asarray(input_ids, dtype=np.int64)
    cut = np.where(ids == EVENT_TOKEN_INDEX)[0]
    segments: List[np.ndarray] = []
    prev = 0
    for c in cut.tolist():
        segments.append(ids[prev:c])
        prev = c + 1
    segments.append(ids[prev:])
    return segments


class ByteTokenizer:
    """Self-contained byte-level tokenizer (offline tests / smoke runs).

    Vocabulary: 0=PAD, 1=BOS, 2=EOS, bytes at 3..258, then dynamically
    registered special tokens. Implements the subset of the HF tokenizer
    protocol this framework touches, so the full pipeline can run without
    any downloaded tokenizer asset.
    """

    def __init__(self) -> None:
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self._byte_offset = 3
        # Literal "<s>"/"</s>" in text map to the real BOS/EOS ids, the
        # behavior LLaVA-style prompt assembly relies on from sentencepiece.
        self._special: dict[str, int] = {"<s>": 1, "</s>": 2}

    _NUM_RESERVED_SPECIAL = 2  # <s>, </s> map into the base vocab

    def __len__(self) -> int:
        return 259 + len(self._special) - self._NUM_RESERVED_SPECIAL

    def add_tokens(self, tokens: Sequence[str], special_tokens: bool = True) -> int:
        added = 0
        for t in tokens:
            if t not in self._special:
                self._special[t] = len(self)
                added += 1
        return added

    def _encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        specials = sorted(self._special, key=len, reverse=True)
        while i < len(text):
            for s in specials:
                if text.startswith(s, i):
                    ids.append(self._special[s])
                    i += len(s)
                    break
            else:
                ids.extend(b + self._byte_offset for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        ids = self._encode_text(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return {"input_ids": ids}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self._special.items()}
        out: List[str] = []
        buf = bytearray()

        def flush() -> None:
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            if i in (self.pad_token_id, self.bos_token_id, self.eos_token_id):
                if not skip_special_tokens:
                    flush()
                    out.append({0: "<pad>", 1: "<s>", 2: "</s>"}[i])
                continue
            if i in inv:
                flush()
                if not skip_special_tokens:
                    out.append(inv[i])
                continue
            if i >= self._byte_offset and i < self._byte_offset + 256:
                buf.append(i - self._byte_offset)
        flush()
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def load_tokenizer(model_path: str):
    """The tokenizer for ``model_path``: ``'byte'`` selects the offline
    ByteTokenizer. The HF tokenizer (``AutoTokenizer.from_pretrained(...,
    use_fast=False)`` over a checkpoint's ``tokenizer.model``) is not
    ported: it needs ``transformers`` and sentencepiece, which the card
    machine lacks, so any other path raises."""
    if model_path == "byte":
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {model_path!r}: the HF tokenizer (tokenizer.model through "
        f"transformers/sentencepiece) is not ported to eventgpt_tpu_torch yet; "
        f"pass --tokenizer_path byte")
