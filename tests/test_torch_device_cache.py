"""The port's device batch cache (``data/device_cache.py``) against the JAX
package's ``DeviceCachedBatches``, on the CPU, over the synthetic corpus:
for one seed the same cached batches (composition and one padded shape)
in the same per-epoch order over three epochs of the stream. Inputs,
lengths and speaker ids are equal; targets within the featurizer's
tolerances of ``tests/test_torch_train_data.py`` (mel 1e-5, linear 2e-4
absolute)."""

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data.device_cache import DeviceCachedBatches as JCache
from nspeech_tpu.data.feeder import DataFeeder as JFeeder
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.data.device_cache import DeviceCachedBatches as TCache
from nspeech_tpu_torch.data.feeder import DataFeeder as TFeeder
from nspeech_tpu_torch.train.loop import TacotronBatch, batch_to_device

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

HP = "batch_size=2,batch_group_size=2"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return {"ljspeech": make_corpus(str(tmp_path_factory.mktemp("corpus")), n=7)}


@pytest.mark.parametrize("variants,seed", [(1, 0), (3, 5)])
def test_cache_matches_jax(corpus, variants, seed):
    jc = JCache(JFeeder(corpus, j_load("taco2").parse(HP), seed=seed),
                n_epoch_variants=variants, seed=seed)
    tc = TCache(TFeeder(corpus, t_load("taco2").parse(HP), seed=seed), "cpu",
                n_epoch_variants=variants, seed=seed)
    assert tc.n_batches == jc.n_batches == 3 * variants
    shapes = set()
    for (_, j), (_, t) in zip(zip(range(3 * tc.n_batches), jc.batches()),
                              zip(range(3 * tc.n_batches), tc.batches())):
        assert isinstance(t, TacotronBatch)
        for name in ("inputs", "input_lengths", "speaker_ids"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(jax.device_get(getattr(j, name))))
        np.testing.assert_allclose(t.mel_targets.numpy(), np.asarray(j.mel_targets),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(t.linear_targets.numpy(),
                                   np.asarray(j.linear_targets), atol=2e-4, rtol=0)
        shapes.add((t.inputs.shape, t.mel_targets.shape))
        # a cached batch passes the runner's conversion untouched
        assert batch_to_device(t, "cpu") is t
    assert len(shapes) == 1
    # the port holds int64 ids and no waveform stub: the same size within 1%
    assert abs(tc.cached_mb - jc.cached_mb) <= 0.01 * jc.cached_mb
