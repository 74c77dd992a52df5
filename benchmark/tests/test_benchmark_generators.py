"""Traffic generation is fixed by the seed, and every seed gets the same
sizes; the frozen operation counts equal the port's."""

import numpy as np
import pytest

from benchmark.harness import flops, gen
from benchmark.harness.core import config
from benchmark.reference.text import to_ids


def test_texts_deterministic_per_seed_and_in_alphabet():
    a = gen.texts(2 ** 31 + 7, 50, 20, 180)
    assert a == gen.texts(2 ** 31 + 7, 50, 20, 180)
    assert a != gen.texts(2 ** 31 + 8, 50, 20, 180)
    assert all(20 - 12 <= len(t) <= 180 for t in a)
    assert 85 <= np.mean([len(t) for t in a]) <= 105
    assert all(to_ids(t) for t in a)


def test_arrivals_same_gaps_in_another_order():
    a, b = gen.arrivals(1, 0.8, 51), gen.arrivals(2, 0.8, 51)
    assert len(a) == len(b) == 40
    np.testing.assert_array_equal(a, gen.arrivals(1, 0.8, 51))
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(np.sort(np.diff(np.append(a, 51))),
                               np.sort(np.diff(np.append(b, 51))), rtol=1e-9)
    assert a[0] == 0 and a[-1] < 51


def test_durations_same_multiset():
    a, b = gen.durations(3, 256, 1, 10, 6.6), gen.durations(4, 256, 1, 10, 6.6)
    np.testing.assert_allclose(np.sort(a), np.sort(b))
    assert abs(a.mean() - 6.6) < 0.01 and a.min() >= 1 and a.max() <= 10


def test_check_sample_holds_the_longest():
    texts = gen.texts(9, 30, 20, 180)
    s = gen.check_sample(9, texts, 8)
    assert len(s) == 8 and int(np.argmax([len(t) for t in texts])) in s
    assert s == gen.check_sample(9, texts, 8)


@pytest.mark.parametrize("shape", [(32, 160, 400), (8, 96, 250), (1, 21, 85)])
def test_frozen_flop_count_equals_the_ports(shape):
    from nspeech_tpu_torch.cli.bench import taco2_flop_terms
    from nspeech_tpu_torch.config import Config
    c = config("tacotron2_wavenet")["taco2"]
    b, t_in, t_out = shape
    assert flops.taco2_flop_terms(c, b, t_in, t_out) == taco2_flop_terms(Config(c), b, t_in, t_out)


def test_sampler_bound():
    assert flops.sampler_sample_flops(config("tacotron2_wavenet")["wavenet"]) == 3_448_832
