"""Supervised finetuning data pipeline: dataset, tokenization, collator.

The port of ``eventgpt_tpu/train/data.py``, numpy on the host as there:
``EventChatDataset`` loads a JSON list of conversations whose human turns
may reference an ``.npy`` event stream; turns are rendered with the
Vicuna-v1 template and tokenized with ``IGNORE_INDEX`` masking of
everything except assistant responses (``preprocess_v1``), or as bare
``<event>\\ncaption`` pairs for projector warm-up (``preprocess_plain``).
Each turn chunk is tokenized once and concatenated, so masks are exact by
construction.

The collator emits a *fixed-layout* batch: each event sentinel is expanded
to ``num_event_tokens`` slots with a gather-index map, so the device-side
splice is a gather and a ``where`` (``train/steps.multimodal_embeds``).
``batch_iterator`` shuffles with numpy's ``default_rng(seed)``, so a seed
gives the JAX package's batch order. An ``image`` entry is a still image
decoded by Pillow, padded square by ``expand2square`` and replicated over
the frames; where Pillow is missing (the card machine) it raises an
``ImportError`` naming Pillow.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import (
    DEFAULT_EV_END_TOKEN,
    DEFAULT_EV_START_TOKEN,
    DEFAULT_EVENT_TOKEN,
    EVENT_TOKEN_INDEX,
    IGNORE_INDEX,
    SEQ_BUCKET,
)
from eventgpt_tpu_torch.data.conversation import conv_templates
from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event


def preprocess_multimodal(text: str, cfg: EventChatConfig) -> str:
    """Normalize the <event> placeholder inside a human turn.

    Mirrors ``preprocess_multimodal`` in the training pyc: the placeholder is
    moved to the front of the turn and optionally wrapped in start/end tokens
    (``mm_use_im_start_end``, ``model/EventChatModel.py:193-235``).
    """
    if DEFAULT_EVENT_TOKEN not in text:
        return text
    text = text.replace(DEFAULT_EVENT_TOKEN, "").strip()
    token = DEFAULT_EVENT_TOKEN
    if cfg.mm_use_im_start_end:
        token = DEFAULT_EV_START_TOKEN + token + DEFAULT_EV_END_TOKEN
    return token + "\n" + text


def _encode_chunk(tokenizer: Any, text: str, with_event: bool) -> List[int]:
    """Tokenize one chunk without BOS, splicing -200 sentinels if present."""
    if with_event and DEFAULT_EVENT_TOKEN in text:
        ids = tokenize_with_event(text, tokenizer)
        bos = getattr(tokenizer, "bos_token_id", None)
        if bos is not None and ids and ids[0] == bos:
            ids = ids[1:]
    else:
        ids = tokenizer(text, add_special_tokens=False)["input_ids"]
    return list(ids)


def preprocess_v1(
    conversations: Sequence[Dict[str, str]],
    tokenizer: Any,
    cfg: EventChatConfig,
) -> Dict[str, List[int]]:
    """Vicuna-v1 supervised tokenization with human-turn masking.

    ``conversations``: [{"from": "human"|"gpt", "value": str}, ...].
    Returns {"input_ids", "labels"} where labels are IGNORE_INDEX everywhere
    except assistant response tokens (incl. the closing </s>).
    """
    conv = conv_templates["eventgpt_v1"]
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    sep, sep2 = conv.sep, conv.sep2

    input_ids: List[int] = []
    labels: List[int] = []

    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None:
        input_ids.append(bos)
        labels.append(IGNORE_INDEX)

    def masked(text: str, with_event: bool = False):
        ids = _encode_chunk(tokenizer, text, with_event)
        input_ids.extend(ids)
        labels.extend([IGNORE_INDEX] * len(ids))

    def supervised(text: str):
        ids = _encode_chunk(tokenizer, text, with_event=False)
        input_ids.extend(ids)
        labels.extend(ids)

    masked(conv.system + sep)
    for i, turn in enumerate(conversations):
        role = roles[turn["from"]]
        value = turn["value"]
        if turn["from"] == "human":
            value = preprocess_multimodal(value, cfg)
            masked(f"{role}: {value}{sep}", with_event=True)
        else:
            masked(f"{role}: ")
            supervised(f"{value}{sep2}")
    return {"input_ids": input_ids, "labels": labels}


def preprocess_plain(
    conversations: Sequence[Dict[str, str]],
    tokenizer: Any,
    cfg: EventChatConfig,
) -> Dict[str, List[int]]:
    """Projector warm-up pairs: ``<event>\\ncaption</s>``; only the caption
    (+ terminator) is supervised (``preprocess_plain`` in the pyc)."""
    assert len(conversations) == 2, "plain mode expects one human/gpt pair"
    caption = conversations[1]["value"]

    input_ids: List[int] = []
    labels: List[int] = []
    bos = getattr(tokenizer, "bos_token_id", None)
    if bos is not None:
        input_ids.append(bos)
        labels.append(IGNORE_INDEX)
    input_ids.append(EVENT_TOKEN_INDEX)
    labels.append(IGNORE_INDEX)
    nl = _encode_chunk(tokenizer, "\n", False)
    input_ids.extend(nl)
    labels.extend([IGNORE_INDEX] * len(nl))
    cap = _encode_chunk(tokenizer, caption + (conv_templates["eventgpt_plain"].sep2 or ""), False)
    input_ids.extend(cap)
    labels.extend(cap)
    return {"input_ids": input_ids, "labels": labels}


PREPROCESSORS = {"v1": preprocess_v1, "plain": preprocess_plain}


@dataclass
class Sample:
    input_ids: List[int]
    labels: List[int]
    pixel_values: Optional[np.ndarray]  # (T_frames, 3, S, S) or None (text-only)


class EventChatDataset:
    """JSON-list supervised dataset (EventChatDataset in the pyc).

    Entry schema::

        {"id": ..., "event": "relative/path.npy",   # or "image": "x.png"
         "conversations": [{"from": "human", "value": "...<event>..."},
                           {"from": "gpt", "value": "..."}]}

    ``__getitem__`` loads + rasterizes the event stream (5-frame equal-count
    split, ``common/common.py:17-37`` semantics) and tokenizes the dialog.
    Lazy by default: raw JSON in memory, events read per access.
    """

    def __init__(
        self,
        data_path: str,
        tokenizer: Any,
        cfg: EventChatConfig,
        event_folder: str = "",
        conv_version: str = "v1",
        image_aspect_ratio: str = "square",
    ):
        with open(data_path) as f:
            self.entries = json.load(f)
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.event_folder = event_folder
        self.preprocess = PREPROCESSORS[conv_version]
        self.image_aspect_ratio = image_aspect_ratio

    def __len__(self) -> int:
        return len(self.entries)

    def modality_lengths(self) -> List[int]:
        """Signed token-length proxy per entry: positive for multimodal,
        negative for text-only (``group_by_modality_length``, SURVEY.md §2.2)."""
        out = []
        for e in self.entries:
            n = sum(len(t["value"].split()) for t in e["conversations"])
            out.append(n if ("event" in e or "image" in e) else -n)
        return out

    def _load_pixels(self, entry: Dict[str, Any]) -> Optional[np.ndarray]:
        from eventgpt_tpu_torch.ops.image import (clip_preprocess_batch, expand2square,
                                                  process_event_file)

        if "event" in entry:
            path = os.path.join(self.event_folder, entry["event"])
            if path.endswith(".npy"):
                _, pixels = process_event_file(
                    path, self.cfg.num_event_frames, self.cfg.vision.image_size
                )
                return pixels
            raise ValueError(f"unsupported event file: {path}")
        if "image" in entry:
            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError(
                    f"image entry {entry['image']!r}: decoding a still image needs Pillow "
                    f"(PIL), which is not installed; use event (.npy) entries") from e
            img = np.asarray(
                Image.open(os.path.join(self.event_folder, entry["image"])).convert("RGB"))
            if self.image_aspect_ratio == "square":
                # Padded to square on the CLIP mean before preprocessing
                # (LLaVA's dataset).
                img = expand2square(img)
            # A still image is replicated over the temporal axis, so the
            # event pipeline's frame count applies unchanged.
            frames = [img] * self.cfg.num_event_frames
            return clip_preprocess_batch(frames, self.cfg.vision.image_size)
        return None

    def __getitem__(self, idx: int) -> Sample:
        entry = self.entries[idx]
        conversations = copy.deepcopy(entry["conversations"])
        pixels = self._load_pixels(entry)
        if pixels is None:
            # Text-only sample: strip any stray placeholder.
            for t in conversations:
                t["value"] = t["value"].replace(DEFAULT_EVENT_TOKEN, "")
        tok = self.preprocess(conversations, self.tokenizer, self.cfg)
        return Sample(tok["input_ids"], tok["labels"], pixels)


def collate_fixed_layout(
    samples: Sequence[Sample],
    cfg: EventChatConfig,
    max_len: Optional[int] = None,
    bucket: int = SEQ_BUCKET,
) -> Dict[str, np.ndarray]:
    """Fixed-layout multimodal batch (the fixed-shape splice redesign).

    Each -200 sentinel is expanded to ``cfg.num_event_tokens`` slots. Output
    arrays (B, T):

      * ``token_ids``   — text ids; 0 at event slots and padding
      * ``labels``      — IGNORE_INDEX at event slots + padding (parity with
                          ``model/EventChatModel.py:357-360``)
      * ``attn_mask``   — True over real (text+event) positions
      * ``event_pos``   — True at event slots
      * ``event_index`` — position within the event block, clipped to [0, E)
      * ``pixel_values``— (B, T_frames, 3, S, S); zeros for text-only rows
                          (the dummy-image pattern of the reference collator)

    Sequences are truncated to the model context (``model/EventChatModel.py:
    378-381``) and padded up to a bucket multiple for shape stability.
    """
    e_tok = cfg.num_event_tokens
    ctx = cfg.llama.max_seq_len if max_len is None else min(max_len, cfg.llama.max_seq_len)

    expanded: List[Dict[str, np.ndarray]] = []
    for s in samples:
        ids = np.asarray(s.input_ids, dtype=np.int64)
        labs = np.asarray(s.labels, dtype=np.int64)
        sent = np.where(ids == EVENT_TOKEN_INDEX)[0]
        if len(sent) > 1:
            raise ValueError("at most one event stream per sample is supported")
        if len(sent) == 1 and s.pixel_values is None:
            raise ValueError("sample has <event> sentinel but no event data")
        if len(sent) == 1:
            off = int(sent[0])
            tid = np.concatenate([ids[:off], np.zeros(e_tok, np.int64), ids[off + 1:]])
            lab = np.concatenate(
                [labs[:off], np.full(e_tok, IGNORE_INDEX, np.int64), labs[off + 1:]]
            )
            pos = np.zeros(len(tid), bool)
            pos[off:off + e_tok] = True
            eidx = np.clip(np.arange(len(tid)) - off, 0, e_tok - 1)
        else:
            tid, lab = ids, labs
            pos = np.zeros(len(tid), bool)
            eidx = np.zeros(len(tid), np.int64)
        if len(sent) == 1 and int(sent[0]) + e_tok > ctx:
            raise ValueError(
                f"context cap {ctx} truncates into the event block at offset "
                f"{int(sent[0])} (+{e_tok} event tokens); shorten the prompt "
                f"or raise model_max_length"
            )
        expanded.append({
            "token_ids": tid[:ctx], "labels": lab[:ctx],
            "event_pos": pos[:ctx], "event_index": eidx[:ctx],
        })

    t_max = max(len(e["token_ids"]) for e in expanded)
    t_max = min(((t_max + bucket - 1) // bucket) * bucket, ctx) if bucket else t_max
    t_max = max(t_max, max(len(e["token_ids"]) for e in expanded))

    b = len(samples)
    batch = {
        "token_ids": np.zeros((b, t_max), np.int32),
        "labels": np.full((b, t_max), IGNORE_INDEX, np.int64),
        "attn_mask": np.zeros((b, t_max), bool),
        "event_pos": np.zeros((b, t_max), bool),
        "event_index": np.zeros((b, t_max), np.int32),
    }
    for i, e in enumerate(expanded):
        n = len(e["token_ids"])
        batch["token_ids"][i, :n] = e["token_ids"]
        batch["labels"][i, :n] = e["labels"]
        batch["attn_mask"][i, :n] = True
        batch["event_pos"][i, :n] = e["event_pos"]
        batch["event_index"][i, :n] = e["event_index"]

    pix_shape = (
        b, cfg.num_event_frames, cfg.vision.num_channels,
        cfg.vision.image_size, cfg.vision.image_size,
    )
    pixels = np.zeros(pix_shape, np.float32)
    for i, s in enumerate(samples):
        if s.pixel_values is not None:
            pixels[i] = s.pixel_values
    batch["pixel_values"] = pixels
    batch["labels"] = batch["labels"].astype(np.int32)
    return batch


def batch_iterator(
    dataset: EventChatDataset,
    batch_size: int,
    cfg: EventChatConfig,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    group_by_modality_length: bool = False,
    max_len: Optional[int] = None,
):
    """Epoch iterator yielding collated numpy batches.

    ``group_by_modality_length`` sorts by the signed length proxy within
    shuffled megabatches (the HF ``LengthGroupedSampler`` idea the recovered
    TrainingArguments toggles, SURVEY.md §2.2) to reduce padding waste.
    """
    n = len(dataset)
    order = np.arange(n)
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    if group_by_modality_length:
        lengths = np.asarray(dataset.modality_lengths())
        mega = batch_size * 50
        chunks = [order[i:i + mega] for i in range(0, n, mega)]
        order = np.concatenate([
            c[np.argsort(-np.abs(lengths[c]) + (lengths[c] < 0) * 10**6, kind="stable")]
            for c in chunks
        ])
    end = n - n % batch_size if drop_last else n
    for i in range(0, end, batch_size):
        idxs = order[i:i + batch_size]
        yield collate_fixed_layout([dataset[int(j)] for j in idxs], cfg, max_len=max_len)


def synthetic_multimodal_batch(
    cfg: EventChatConfig,
    batch: int,
    seq: int,
    event_offset: int = 35,
    pixel_values: Optional[np.ndarray] = None,
    mask_event_labels: bool = False,
) -> Dict[str, np.ndarray]:
    """Fixed-layout batch with one event block per row, synthetic text ids.

    The single source of the fixed-layout invariant for harnesses that don't
    run the tokenizer (dry runs, benchmarks): text ids surround an
    ``num_event_tokens`` event slot block starting at ``event_offset``, with
    the gather-index map ``collate_fixed_layout`` would produce.
    """
    e = cfg.num_event_tokens
    if event_offset + e >= seq:
        raise ValueError(f"seq={seq} too small for {e} event tokens at offset {event_offset}")
    token_ids = np.zeros((batch, seq), np.int32)
    token_ids[:, :event_offset] = 7
    token_ids[:, event_offset + e:] = 9
    attn = np.ones((batch, seq), bool)
    pos = np.zeros((batch, seq), bool)
    pos[:, event_offset:event_offset + e] = True
    eidx = np.clip(np.arange(seq) - event_offset, 0, e - 1)[None].repeat(batch, 0)
    if pixel_values is None:
        pixel_values = np.zeros(
            (batch, cfg.num_event_frames, cfg.vision.num_channels,
             cfg.vision.image_size, cfg.vision.image_size), np.float32,
        )
    labels = np.where(pos if mask_event_labels else ~attn, IGNORE_INDEX, token_ids)
    return {
        "token_ids": token_ids, "labels": labels.astype(np.int32),
        "attn_mask": attn, "event_pos": pos,
        "event_index": eidx.astype(np.int32), "pixel_values": pixel_values,
    }
