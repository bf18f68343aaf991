"""Streaming event QA: the native threaded reader feeds fixed windows to the model.

The port of ``scripts/stream_demo.py``. ``native.EventStream`` replays a
txt ("t x y p") or structured-npy stream on its own C++ producer thread;
each complete window (50 ms by default) goes through ``events_window_us``
-> ``events_to_frames`` -> ``clip_preprocess_batch`` ->
``eventchat.generate``, one greedy answer per window, on ``--device``
(default ``cuda``). Without ``--events`` a structured stream is
synthesized from ``ops.raster.synthetic_event_stream(--seed)``.

Windows are counted in integer microseconds (``t`` read back from the
reader's float seconds, rounded): an event at exactly a window's end
opens the next window. The JAX script adds float seconds to its cursor,
so there an event at 150 ms can fall in the window that ends at 150 ms.

Usage:
  python -m eventgpt_tpu_torch.scripts.stream_demo [--events stream.npy|stream.txt] \\
      [--model_path tiny-random|DIR --tokenizer_path byte] [--query "..."] \\
      [--window_ms 50] [--max_windows 3] [--paced --pace_factor 10] [--device cpu]

The Python side runs on the main thread; the only other thread is the
reader's, behind the ctypes seam.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

_FIELDS = (("x", np.uint16), ("y", np.uint16), ("t", np.float64), ("p", np.uint8))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Streaming event QA (PyTorch)")
    p.add_argument("--events", type=str, default=None,
                   help="txt ('t x y p') or structured npy stream; synthesized if absent")
    p.add_argument("--model_path", type=str, default="tiny-random")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--query", type=str, default="What is happening?")
    p.add_argument("--conv_mode", type=str, default="eventgpt_v1")
    p.add_argument("--window_ms", type=float, default=50.0)
    p.add_argument("--max_windows", type=int, default=3)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--paced", action="store_true", help="replay at wall-clock rate")
    p.add_argument("--pace_factor", type=float, default=1.0)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4"])
    p.add_argument("--speculative", type=int, default=0,
                   help="speculative greedy decode window (the same answers)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_event_qformer", action="store_true")
    p.add_argument("--pretrain_query_embedder", type=str, default=None)
    p.add_argument("--pretrain_attention_layers", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


def synthesize_stream(out_dir: str, seed: int = 0) -> str:
    """A structured npy the native reader replays: one seeded synthetic
    stream (there is no reference sample in the repository)."""
    from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

    path = os.path.join(out_dir, f"stream_demo_events_{seed}.npy")
    np.save(path, synthetic_event_stream(seed))
    return path


def stream_answers(cfg, params, tokenizer, events_path: str, query: str = "What is happening?",
                   conv_mode: str = "eventgpt_v1", window_ms: float = 50.0,
                   max_windows: int = 3, max_new_tokens: int = 32, paced: bool = False,
                   pace_factor: float = 1.0, speculative: int = 0, device="cuda",
                   on_window=None) -> Dict:
    """Answer ``query`` once per complete window of the stream, in order.
    Returns {"windows": [{start_us, events, ms, ids, answer}], "pops",
    "popped"} (the reader's pop calls and the events they returned);
    ``on_window(record)`` sees each window as it is answered."""
    from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
    from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
    from eventgpt_tpu_torch.models import eventchat
    from eventgpt_tpu_torch.native import EventStream
    from eventgpt_tpu_torch.ops.image import clip_preprocess_batch
    from eventgpt_tpu_torch.ops.raster import events_to_frames, events_window_us

    input_ids = tokenize_with_event(prepare_event_prompt(query, conv_mode), tokenizer)
    window_us = int(round(window_ms * 1e3))
    if window_us <= 0:
        raise ValueError(f"window_ms must be positive, got {window_ms}")
    windows: List[Dict] = []
    # One array per field; events behind the cursor are dropped after each
    # round, so memory and work per window stay bounded by the window.
    buf = {k: np.empty(0, d) for k, d in _FIELDS}
    t_us = np.empty(0, np.int64)
    cursor = None
    with EventStream(events_path, paced=paced, pace_factor=pace_factor) as stream:
        while len(windows) < max_windows:
            out = stream.pop_until(1e18)  # whatever the producer has pushed
            if out["t"].size:
                buf = {k: np.concatenate([buf[k], out[k]]) for k in buf}
                t_us = np.concatenate([t_us, np.rint(out["t"] * 1e6).astype(np.int64)])
            if cursor is None and t_us.size:
                cursor = int(t_us.min())
            # Every complete window in the buffer; at the stream's end, the rest.
            while (cursor is not None and t_us.size and len(windows) < max_windows
                   and (t_us.max() >= cursor + window_us or not stream.running())):
                sel = (t_us >= cursor) & (t_us < cursor + window_us)
                n = int(sel.sum())
                if n >= cfg.num_event_frames:
                    t0 = time.perf_counter()
                    frames = events_to_frames(events_window_us(buf, sel), cfg.num_event_frames)
                    pixels = clip_preprocess_batch(frames, cfg.vision.image_size)
                    ids = eventchat.generate(
                        params, cfg, [input_ids], pixels[None], max_new_tokens=max_new_tokens,
                        temperature=0.0, eos_token_id=getattr(tokenizer, "eos_token_id", None),
                        speculative=speculative, device=device)[0]
                    answer = tokenizer.batch_decode([ids], skip_special_tokens=True)[0].strip()
                    rec = {"start_us": cursor, "events": n,
                           "ms": (time.perf_counter() - t0) * 1e3, "ids": list(ids),
                           "answer": answer}
                    windows.append(rec)
                    if on_window is not None:
                        on_window(rec)
                cursor += window_us
                if not stream.running() and t_us.max() < cursor:
                    break
            if cursor is not None and t_us.size:
                keep = t_us >= cursor  # windows only advance
                if not keep.all():
                    buf = {k: buf[k][keep] for k in buf}
                    t_us = t_us[keep]
            if not stream.running() and (t_us.size == 0 or t_us.max() < cursor):
                break
            time.sleep(0.005)
        return {"windows": windows, "pops": stream.pops, "popped": stream.popped}


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
    from eventgpt_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    events_path = args.events
    if events_path is None:
        events_path = synthesize_stream(tempfile.gettempdir(), args.seed)
        print(f"[stream] synthesized {events_path} from synthetic_event_stream({args.seed})",
              file=sys.stderr)
    cfg, params, tokenizer = load_model(args.model_path, args.dtype, None, args.tokenizer_path,
                                        device, args.seed)
    cfg, params = prepare_model(cfg, params, tokenizer, args)

    def show(rec):
        print(f"[{rec['start_us'] / 1e3:8.1f}ms +{args.window_ms:.0f}ms | {rec['events']} events"
              f" | {rec['ms']:.0f} ms] {rec['answer']}", flush=True)

    out = stream_answers(cfg, params, tokenizer, events_path, args.query, args.conv_mode,
                         args.window_ms, args.max_windows, args.max_new_tokens, args.paced,
                         args.pace_factor, args.speculative, device, on_window=show)
    print(f"[stream] answered {len(out['windows'])} window(s); {out['pops']} pops, "
          f"{out['popped']} events", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
