"""The port's numpy copy of JAX's default PRNG (``ops/threefry.py``)
against ``jax.random``, and the Griffin-Lim phase the port's synthesizer
draws from it against the JAX synthesizer's. Tolerance: none, every key
and every float must be equal."""

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.ops import threefry
from nspeech_tpu_torch.serving import Synthesizer

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,n,shape", [
    (0, 1, (3, 5)), (0, 2, (7, 1025)), (0, 4, (1,)), (0, 3, (2, 3, 4)),
    (7, 5, (33,)), (123456789, 8, (4, 17))])
def test_split_and_uniform_match_jax(seed, n, shape):
    jkeys = jax.random.split(jax.random.PRNGKey(seed), n)
    keys = threefry.split(threefry.prng_key(seed), n)
    np.testing.assert_array_equal(keys, np.asarray(jax.random.key_data(jkeys)))
    for i in range(n):
        want = np.asarray(jax.random.uniform(jkeys[i], shape))
        got = threefry.uniform(keys[i], shape)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_synthesizer_phase_is_jax_phase():
    """``Synthesizer.initial_phase`` draws row i as the JAX synthesizer
    does: ``uniform(split(PRNGKey(0), n)[i], shape[1:])``."""
    n, shape = 4, (9, 1025)
    phase = Synthesizer(load_config("taco2"), device="cpu").initial_phase(
        (n,) + shape)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    want = np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys])
    assert phase.dtype == torch.float32
    np.testing.assert_array_equal(phase.numpy(), want)
