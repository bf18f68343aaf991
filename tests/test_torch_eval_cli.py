"""The port's batched evaluation CLI (``cli/eval``) against the JAX package's,
f32 on the CPU over one tiny checkpoint both packages load.

- Three synthetic event files with three distinct queries (``--queries_json``)
  through one batched ``generate`` each: the port prints the JAX CLI's
  answers, and ``evaluate`` returns the chains behind them.
- ``--expected``: a file of the same answers exits 0 (every PASS), a file
  with one wrong answer exits 1; a query count other than the file count
  and an expected count other than the answer count raise ValueError;
  ``--mesh_*`` in one process raises ValueError naming the launcher, as
  ``cli/infer`` does.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from eventgpt_tpu.cli import eval as jeval
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import eval as teval
from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

QUERIES = ["What is happening?", "Describe the motion.", "Is anything moving left?"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    cfg = tcfg.EventChatConfig.tiny()
    params = tconv.init_eventchat_params(cfg, torch.Generator().manual_seed(7),
                                         torch.float32, "cpu")
    ckpt = str(root / "ckpt")
    tconv.write_hf_checkpoint(params, cfg, ckpt, num_shards=1)
    files = []
    for i in range(len(QUERIES)):
        files.append(str(root / f"ev{i}.npy"))
        np.save(files[-1], synthetic_event_stream(70 + i, n_events=6000, height=96, width=128))
    queries = str(root / "queries.json")
    with open(queries, "w") as f:
        json.dump(QUERIES, f)
    common = ["--model_path", ckpt, "--tokenizer_path", "byte", "--event_frames",
              ",".join(files), "--queries_json", queries, "--max_new_tokens", "6",
              "--dtype", "float32"]
    return root, common, files


@pytest.fixture(scope="module")
def jax_answers(setup):
    return jeval.main(setup[1])


def test_batched_answers_equal_the_jax_cli(setup, jax_answers, capsys):
    root, common, files = setup
    got = teval.main(common + ["--device", "cpu"])
    assert got == jax_answers and len(set(got)) > 1
    out = capsys.readouterr().out
    assert all(f"=== {f}\n{a}" in out for f, a in zip(files, got))
    # The function main calls, over a tree loaded as main loads it.
    args = teval.build_parser().parse_args(common + ["--device", "cpu"])
    cfg, params, tok = load_model(args.model_path, "float32", None, "byte", "cpu")
    cfg, params = prepare_model(cfg, params, tok, args)
    res = teval.evaluate(cfg, params, tok, files, QUERIES, args, "cpu")
    assert res["answers"] == got
    assert [a.strip() for a in tok.batch_decode(res["ids"], skip_special_tokens=True)] == got


def test_expected_transcripts_gate_the_exit_code(setup, jax_answers, capsys):
    root, common, _ = setup
    good, bad = root / "good.json", root / "bad.json"
    good.write_text(json.dumps(jax_answers))
    bad.write_text(json.dumps(jax_answers[:-1] + [jax_answers[-1] + " not this"]))
    assert teval.main(common + ["--device", "cpu", "--expected", str(good)]) == jax_answers
    err = capsys.readouterr().err
    assert err.count("[PASS]") == 3 and "[FAIL]" not in err
    with pytest.raises(SystemExit) as exc:
        teval.main(common + ["--device", "cpu", "--expected", str(bad)])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert err.count("[PASS]") == 2 and err.count("[FAIL]") == 1
    assert "1/3 transcript mismatches" in err
    short = root / "short.json"
    short.write_text(json.dumps(jax_answers[:2]))
    with pytest.raises(ValueError, match="2 expected answers for 3 samples"):
        teval.main(common + ["--device", "cpu", "--expected", str(short)])


def test_query_count_mismatch_and_mesh_refusal(setup):
    root, common, files = setup
    two = root / "two.json"
    two.write_text(json.dumps(QUERIES[:2]))
    argv = [a if a != str(root / "queries.json") else str(two) for a in common]
    with pytest.raises(ValueError, match="2 queries for 3 event files"):
        teval.main(argv + ["--device", "cpu"])
    args = argparse.Namespace(queries_json=str(two))
    with pytest.raises(ValueError, match="2 queries for 3 event files"):
        teval.read_queries(args, 3)
    for flag in ("--mesh_data", "--mesh_fsdp", "--mesh_model"):
        # A mesh needs a launched world of its size (one process here).
        with pytest.raises(ValueError, match="mesh.*torch.distributed.run"):
            teval.main(common + ["--device", "cpu", flag, "2"])
    with pytest.raises(ValueError, match="draft_head"):
        teval.main(common + ["--device", "cpu", "--draft_head", "x.npz"])
