"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length N, then N bytes of JSON
header, then the raw tensor bytes. The header maps each tensor name to
``{"dtype": "BF16" | ..., "shape": [...], "data_offsets": [begin, end]}``
(byte offsets into the data section) and may hold a ``__metadata__`` dict
of strings. The reference reader refuses gaps between tensors, so the
writer packs them back to back: widest element first, then by name, with
the header padded by spaces to a multiple of 8 bytes, so that every tensor
starts on a multiple of its element size (8 for F64 and I64) — the layout
of the ``safetensors`` package's own writer.

The reader maps the file copy-on-write (``mmap``) and views each tensor
with ``torch.frombuffer`` before copying it out, so a shard is read once,
straight into the target device and dtype. bf16 stays in torch throughout:
numpy has no bf16.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional, Tuple, Union

import torch

from eventgpt_tpu_torch.device import resolve_device

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> Tuple[dict, int]:
    """(header dict, byte offset of the data section) of a safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} runs past the end of the file")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str, device: Union[str, torch.device] = "cuda",
              dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, copied onto ``device``; floating
    tensors cast to ``dtype`` when one is given, others kept as stored.
    No tensor returned shares memory with the file."""
    device = resolve_device(device)
    header, start = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > start else None
    try:
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
            tdt = DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            numel = 1
            for d in shape:
                numel *= d
            itemsize = torch.empty((), dtype=tdt).element_size()
            if end - begin != numel * itemsize or start + end > size:
                raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for "
                                 f"shape {list(shape)} of {info['dtype']}")
            want = dtype if dtype is not None and tdt.is_floating_point else tdt
            if numel == 0:
                out[name] = torch.empty(shape, dtype=want, device=device)
                continue
            view = torch.frombuffer(mm, dtype=tdt, count=numel, offset=start + begin)
            out[name] = view.reshape(shape).to(device=device, dtype=want, copy=True)
            del view
    finally:
        if mm is not None:
            mm.close()
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device) as one safetensors file; returns the
    bytes of tensor data written."""
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                # A flat byte view: bf16 and bool have no numpy form.
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    return offset
