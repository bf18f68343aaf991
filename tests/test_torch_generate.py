"""Generation of the PyTorch port against the JAX package, and its CLI.

Greedy chains at f32 must be token-identical to
``eventgpt_tpu.models.eventchat.generate`` on the same weights, at batch
2 with right padding and an EOS that stops one row early (the setting of
tests/test_eventchat.py::test_generate_batch_and_eos).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.ops.sampling import top_p_filter as j_top_p
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import init_eventchat_params, params_from_jax
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.ops.sampling import sample, top_p_filter

JCFG = jcfg.EventChatConfig.tiny(vocab_size=128)
TCFG = tcfg.EventChatConfig.tiny(vocab_size=128)


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree_util.tree_map(np.asarray, jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, TCFG, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    size = JCFG.vision.image_size
    pixels = rng.standard_normal((2, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    ids = [rng.integers(3, 128, 4).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 3).tolist(),
           rng.integers(3, 128, 9).tolist() + [EVENT_TOKEN_INDEX] + rng.integers(3, 128, 6).tolist()]
    return jp, tp, ids, pixels


def test_greedy_chains_token_identical(setup):
    jp, tp, ids, pixels = setup
    want = jchat.generate(jp, JCFG, ids, pixels, max_new_tokens=10, temperature=0.0,
                          eos_token_id=None)
    got = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=10, temperature=0.0,
                         eos_token_id=None, device="cpu")
    assert got == want and all(len(row) == 10 for row in got)

    # An EOS taken from row 0's own chain stops that row early; the other
    # row runs on (frozen rows keep decoding until every row is done).
    eos = want[0][3]
    want_eos = jchat.generate(jp, JCFG, ids, pixels, max_new_tokens=10, temperature=0.0,
                              eos_token_id=eos)
    got_eos = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=10, temperature=0.0,
                             eos_token_id=eos, device="cpu")
    assert got_eos == want_eos
    assert len(got_eos[0]) <= 3


def test_generate_timings_and_zero_budget(setup):
    _, tp, ids, pixels = setup
    timings = {}
    out = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=4, eos_token_id=None,
                         timings=timings, device="cpu")
    assert [len(r) for r in out] == [4, 4]
    assert {"encode_s", "prefill_s", "decode_s", "decode_steps"} <= set(timings)
    assert tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=0, device="cpu") == [[], []]


def test_sampled_generate_is_seeded(setup):
    _, tp, ids, pixels = setup
    a = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=6, temperature=0.7, top_p=0.9,
                       seed=3, eos_token_id=None, device="cpu")
    b = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=6, temperature=0.7, top_p=0.9,
                       seed=3, eos_token_id=None, device="cpu")
    assert a == b


def test_unported_decoders_raise(setup):
    """Beam search and speculative decoding are ported; what still raises
    are the JAX package's own validation errors: speculation with beams,
    and fewer than one beam."""
    _, tp, ids, pixels = setup
    with pytest.raises(ValueError, match="num_beams must be 1"):
        tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=2, num_beams=2, speculative=4,
                       device="cpu")
    with pytest.raises(ValueError, match="num_beams must be >= 1"):
        tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=2, num_beams=0, device="cpu")


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.9, 1.0])
def test_top_p_filter_matches(top_p):
    logits = np.random.default_rng(int(top_p * 10)).standard_normal((3, 50)).astype(np.float32) * 3
    want = np.asarray(j_top_p(jnp.asarray(logits), top_p))
    got = top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])
    # Sampling never leaves the nucleus.
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample(torch.from_numpy(logits), g, temperature=1.0, top_p=top_p).numpy()
        assert not np.isinf(want[np.arange(3), tok]).any()


def test_cli_runs_end_to_end(tmp_path, capsys):
    path = str(tmp_path / "events.npy")
    np.save(path, synthetic_event_stream(5, n_events=20_000))
    out = infer.main(["--model_path", "tiny-random", "--event_frame", path,
                      "--query", "What is happening?", "--device", "cpu",
                      "--temperature", "0", "--max_new_tokens", "6", "--timing"])
    assert isinstance(out, str)
    assert "[timing]" in capsys.readouterr().err
    beam = infer.main(["--model_path", "tiny-random", "--event_frame", path, "--query", "q",
                       "--device", "cpu", "--num_beams", "2", "--max_new_tokens", "4"])
    assert isinstance(beam, str)


def test_entry_points_refuse_a_missing_card(tmp_path):
    """Without ``device='cpu'`` the entry points want a card and raise
    when there is none; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_eventchat_params(TCFG)
    tp = init_eventchat_params(TCFG, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchat.generate(tp, TCFG, [[1, EVENT_TOKEN_INDEX, 5]],
                       np.zeros((1, 5, 3, 28, 28), np.float32), max_new_tokens=2)
    path = str(tmp_path / "events.npy")
    np.save(path, synthetic_event_stream(6, n_events=5_000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--model_path", "tiny-random", "--event_frame", path, "--query", "q"])
