"""A static guard of the port server's dispatch path: no host read of a
device value between two segment dispatches.

The pipelined scheduler overlaps the host's work with the card's only as
long as nothing on the dispatch path waits for the card: one stray
``.item()`` empties the pipeline with no error anywhere. The JAX package's
``hot-sync`` rule (``eventgpt_tpu/analysis/hot_path.py``) scans only the
JAX package, so this test scans the port.

It walks ``eventgpt_tpu_torch/serve.py``'s AST from ``ContinuousBatcher.
step``, ``_dispatch_segment`` and the segment functions (``_decode_segment``,
``_spec_segment`` and their mixed forms) through every ``self.method()``
call and every call of a module-level function, stopping at the two harvest points
(``_harvest_segment``, ``_drain``), where the host is meant to wait. In
every function it reaches it flags ``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``.synchronize()``, and ``bool()``/``int()``/``float()`` of a
call, subscript or attribute (the shape of a tensor's scalar read). What it flags must be on
the allow-list below, each entry with its reason; an entry that no longer
matches anything fails the test too. At run time, a speculative harvest
is one fetch of the slots its segment could write.
"""

import ast
import os

import numpy as np
import torch

from eventgpt_tpu_torch import serve
from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.models.convert import init_eventchat_params

SERVE = os.path.join(os.path.dirname(__file__), os.pardir, "eventgpt_tpu_torch", "serve.py")
CLASS = "ContinuousBatcher"
ROOTS = (f"{CLASS}.step", f"{CLASS}._dispatch_segment", "_decode_segment",
         "_mixed_decode_segment", "_spec_segment", "_mixed_spec_segment")
HARVEST = (f"{CLASS}._harvest_segment", f"{CLASS}._drain")
SYNC_METHODS = ("item", "cpu", "tolist", "numpy", "synchronize")
SCALAR_CASTS = ("bool", "int", "float")

# (function, source of the flagged expression) -> why it is no hidden sync.
ALLOWED = {
    ("_flag_read", "bool(flags.host[i])"):
        "the segment's stop flag: it waits on the event of a flag written "
        "before the previous step was launched, never on the step just "
        "launched (pinned host memory on the card)",
    ("_flag_read", "flags.events[i].synchronize()"):
        "the wait of the stop flag's read on the line above",
    ("_to_host", "torch.cuda.synchronize(src[0].device)"):
        "the spill gather (_gather_spill_record, from _preempt_for) and the "
        "handoff gather (_handoff_gather, from the prefill role's sweep) copy a "
        "block run to the host: host waits at a drained admission boundary "
        "(the preemption decision drains first; the prefill role never "
        "dispatches), outside the pipelined dispatch, as in the JAX package",
    (f"{CLASS}._gather_spill_record", "int(self.base_pos[row])"):
        "base_pos is the host numpy mirror of the speculative rows' positions",
    (f"{CLASS}._prep_request", "int(lens[0])"):
        "lens is the host numpy array eventchat._pad_batch returns",
    (f"{CLASS}._scatter_wave",
     "torch.isfinite(wave_logits[:len(members)]).all(dim=-1).cpu().numpy()"):
        "the admission NaN quarantine; every admission that reaches it runs "
        "after step() drained the pipeline",
    (f"{CLASS}._scatter_wave",
     "torch.isfinite(wave_logits[:len(members)]).all(dim=-1).cpu()"):
        "the same read as the line above",
    (f"{CLASS}._finish_admission", "bool(torch.isfinite(row_logits).all())"):
        "the admission NaN quarantine of a single, suffix, chunked or lane "
        "admission; each runs after step() drained the pipeline",
    (f"{CLASS}._admit_speculative",
     "int(sample(row_logits, self.generator, self.temperature, self.top_p)[0])"):
        "a speculative row's first token, committed at admission (the host "
        "decides EOS and the budget, as the JAX batcher does); it follows the "
        "NaN quarantine's read, after step() drained the pipeline",
}


def _functions(tree):
    """{qualified name: def node} of the module's functions and the
    batcher's methods."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef) and node.name == CLASS:
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{CLASS}.{item.name}"] = item
    return out


def _callees(fn, functions):
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name) and f.id in functions:
            yield f.id
        elif (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
              and f.value.id == "self" and f"{CLASS}.{f.attr}" in functions):
            yield f"{CLASS}.{f.attr}"


def _reached(functions):
    seen, todo = set(), list(ROOTS)
    while todo:
        name = todo.pop()
        if name in seen or name in HARVEST:
            continue
        seen.add(name)
        todo.extend(_callees(functions[name], functions))
    return seen


def _flags(fn):
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
            yield ast.unparse(node)
        elif (isinstance(f, ast.Name) and f.id in SCALAR_CASTS and len(node.args) == 1
              and isinstance(node.args[0], (ast.Call, ast.Subscript, ast.Attribute))):
            yield ast.unparse(node)


def _findings():
    with open(SERVE) as fh:
        tree = ast.parse(fh.read())
    functions = _functions(tree)
    reached = _reached(functions)
    return reached, {(name, src) for name in reached for src in _flags(functions[name])}


def test_the_dispatch_path_reads_nothing_back_but_the_allowed():
    reached, found = _findings()
    assert set(ROOTS) <= reached
    assert not set(HARVEST) & reached
    unexplained = found - set(ALLOWED)
    assert not unexplained, f"host reads on the dispatch path: {sorted(unexplained)}"
    stale = set(ALLOWED) - found
    assert not stale, f"allow-list entries that match nothing: {sorted(stale)}"


def test_the_guard_flags_a_stray_read():
    """The scan itself: a read added to the segment is found."""
    src = ("def _decode_segment(live):\n"
           "    torch.cuda.synchronize()\n"
           "    if bool(live.any()):\n"
           "        return live.cpu()\n")
    fn = ast.parse(src).body[0]
    assert set(_flags(fn)) == {"bool(live.any())", "live.cpu()", "torch.cuda.synchronize()"}


def test_a_speculative_harvest_is_one_fetch(monkeypatch):
    """At run time, with lanes and the pipeline on: every dispatched
    segment starts exactly one device-to-host fetch (the new ids, the
    counts and the acceptance together) and is harvested once, and the
    ids come back only over the slots the segment could have written."""
    cfg = EventChatConfig.tiny()
    params = init_eventchat_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    fetches, harvests = [], []
    real_fetch, real_harvest = serve._fetch_async, serve.ContinuousBatcher._harvest_segment

    def fetch(tensors):
        fetches.append([tuple(t.shape) for t in tensors])
        return real_fetch(tensors)

    def harvest(self, rec):
        harvests.append(rec)
        return real_harvest(self, rec)

    monkeypatch.setattr(serve, "_fetch_async", fetch)
    monkeypatch.setattr(serve.ContinuousBatcher, "_harvest_segment", harvest)
    srv = serve.ContinuousBatcher(params, cfg, max_batch=2, max_len=256, chunk=8,
                                  eos_token_id=None, spec_buckets="0,2,4", prefill_budget=8,
                                  device="cpu")
    size = cfg.vision.image_size
    pv = np.zeros((cfg.num_event_frames, 3, size, size), np.float32)
    srv.submit([1, 5, -200, 9], pv, 12)
    srv.step()
    srv.submit([2, -200, 7], pv, 6)
    srv.run_until_drained()
    assert srv.seg_count == len(fetches) == len(harvests) > 1
    assert srv.mixed_segments > 0
    for shapes in fetches:
        assert len(shapes) == 9  # ids, iterations, n_new, done, frozen, 4 counts
        assert shapes[0] == (2, 8)  # max(chunk, window) slots a row, not max_len
