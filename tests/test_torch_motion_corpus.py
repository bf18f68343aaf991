"""The port's motion-QA corpus (``data/motion_corpus.py``) against the JAX
package's: two builds, one per package, are byte-identical, every
``events/*.npy``, ``train.json`` and ``eval.json``; the helpers agree
value for value."""

import os

import numpy as np
import pytest

from eventgpt_tpu.data import motion_corpus as jcorpus
from eventgpt_tpu_torch.data import motion_corpus as tcorpus


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("n_train,n_eval,seed", [(12, 4, 0), (9, 3, 5)])
def test_builds_are_byte_identical(tmp_path, n_train, n_eval, seed):
    jp = jcorpus.build_motion_corpus(str(tmp_path / "jax"), n_train, n_eval, seed=seed)
    tp = tcorpus.build_motion_corpus(str(tmp_path / "torch"), n_train, n_eval, seed=seed)
    assert {k: os.path.relpath(v, tmp_path / "jax") for k, v in jp.items()} == \
        {k: os.path.relpath(v, tmp_path / "torch") for k, v in tp.items()}
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".npy")]) == n_train + n_eval
    for name in want:
        assert got[name] == want[name], name


def test_helpers_agree():
    assert tcorpus.DIRECTIONS == jcorpus.DIRECTIONS
    assert tcorpus.MOTION_QUESTION == jcorpus.MOTION_QUESTION
    for d in range(len(tcorpus.DIRECTIONS)):
        assert tcorpus.caption(d, 17) == jcorpus.caption(d, 17)
        a = tcorpus.synth_event_stream(d, 11, seed=d)
        b = jcorpus.synth_event_stream(d, 11, seed=d)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
