"""Small public names of the JAX package that callers outside their module
reach, against the port's, on the CPU: ``Config.replace``,
``ValueWindow.count`` and ``.sum``, ``DataFeeder.queue_fill``."""

import itertools
import time

import jax  # noqa: F401  (both frameworks in one process, as in every port test)
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data.feeder import DataFeeder as JFeeder
from nspeech_tpu.utils import ValueWindow as JWindow
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.data.feeder import DataFeeder as TFeeder
from nspeech_tpu_torch.utils import ValueWindow as TWindow

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)


@pytest.mark.parametrize("model", ["taco1", "taco2", "wavenet"])
def test_config_replace_matches_jax(model):
    kw = {"batch_size": 3, "max_iters": 7, "cleaners": "basic_cleaners"}
    jc, tc = j_load(model), t_load(model)
    jr, tr = jc.replace(**kw), tc.replace(**kw)
    assert tr.values() == jr.values()
    assert tr is not tc and tc.values() == jc.values()   # the source unchanged
    assert tr.batch_size == 3 and tc.batch_size == jc.batch_size


def test_value_window_count_and_sum_match_jax():
    jw, tw = JWindow(3), TWindow(3)
    assert (tw.count, tw.sum, tw.average) == (jw.count, jw.sum, jw.average) == (0, 0, 0.0)
    for v in (1.5, 2.0, 4.0, 8.5):
        jw.append(v)
        tw.append(v)
        assert (tw.count, tw.sum, tw.average) == (jw.count, jw.sum, jw.average)
    assert tw.count == 3 and tw.sum == 14.5
    jw.reset()
    tw.reset()
    assert (tw.count, tw.sum) == (jw.count, jw.sum) == (0, 0)


def test_feeder_queue_fill_matches_jax(tmp_path):
    corpus = make_corpus(str(tmp_path / "corpus"), n=4)
    hp = "batch_size=2,batch_group_size=1"
    fills = []
    for load, feeder_cls in ((j_load, JFeeder), (t_load, TFeeder)):
        feeder = feeder_cls({"ljspeech": corpus}, load("taco2").parse(hp),
                            seed=0, prefetch=2)
        assert feeder.queue_fill == 0.0          # before the stream starts
        stream = feeder.batches()
        next(stream)
        deadline = time.monotonic() + 60
        while feeder.queue_fill < 1.0 and time.monotonic() < deadline:
            time.sleep(0.01)                     # the producer fills the queue
        fills.append(feeder.queue_fill)
        list(itertools.islice(stream, 2))
        stream.close()
    assert fills == [1.0, 1.0]
