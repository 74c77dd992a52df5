"""Priming (the sampler's form K3) against the JAX package, on the CPU.

The port's ``CudaWaveNetGenerator`` runs its plain version here (the CUDA
kernel is held against that in ``test_torch_gpu.py``, on a card). At
temperature 0 its codes must equal those of JAX's ``WaveNet.generate`` and
of JAX's Pallas kernel in interpret mode, with lc and per-stream gc: both
sides take the argmax with the lowest-index tie-break, so no tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models.wavenet import WaveNet as JWaveNet
from nspeech_tpu.ops.pallas.wavenet_gen import generate_pallas
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models.wavenet import WaveNet as TWaveNet
from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator

torch.set_num_threads(1)

TINY = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
        "dilation_channels=8,skip_channels=16,quantization_channels=64,"
        "lc_channels=5,gc_channels=4,gc_category_cardinality=3")


@pytest.fixture(scope="module")
def nets():
    jnet = JWaveNet(j_load("wavenet").parse(TINY))
    tnet = TWaveNet(t_load("wavenet").parse(TINY))
    jparams = jnet.init(jax.random.PRNGKey(0))
    tparams = convert.wavenet_params(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    return jnet, jparams, tnet, tparams


@pytest.mark.parametrize("batch,prime_len", [(1, 19), (2, 19), (2, 1), (1, 0)])
def test_primed_codes_match_scan_and_pallas(nets, batch, prime_len):
    """P = RF + 3 forced codes (and a single one, and an empty seed that
    primes nothing) then 15 free samples, lc over P + n samples."""
    jnet, jparams, tnet, tparams = nets
    rng = np.random.default_rng(10 * batch + prime_len)
    n = 15
    seeds = rng.integers(0, 64, (batch, prime_len)).astype(np.int32)
    lc = rng.random((batch, prime_len + n, 5)).astype(np.float32)
    gc = np.array([2, 0][:batch], np.int32)
    j = np.asarray(jnet.generate(jparams, n, jax.random.PRNGKey(1), batch=batch,
                                 gc_ids=jnp.asarray(gc), lc=jnp.asarray(lc),
                                 seed_codes=jnp.asarray(seeds), temperature=0.0))
    p = np.asarray(generate_pallas(jnet, jparams, n, batch=batch,
                                   gc_ids=jnp.asarray(gc), lc=jnp.asarray(lc),
                                   seed_codes=jnp.asarray(seeds),
                                   deterministic=True, interpret=True))
    t = CudaWaveNetGenerator(tnet, tparams, gc_ids=gc.tolist())(
        n, batch=batch, seed_codes=torch.from_numpy(seeds),
        lc=torch.from_numpy(lc), temperature=0.0)
    assert t.shape == (batch, n) and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy(), p)


def test_primed_launch_is_the_unprimed_run_fed_the_seed(nets):
    """The codes kept after priming are the plain generator's steps P - 1
    onwards when the seed is forced as its inputs (``include_prime``)."""
    _, _, tnet, tparams = nets
    rng = np.random.default_rng(3)
    P, n = 20, 12
    seeds = torch.from_numpy(rng.integers(0, 64, (2, P)))
    lc = torch.from_numpy(rng.random((2, P + n, 5)).astype(np.float32))
    gen = CudaWaveNetGenerator(tnet, tparams, gc_ids=[1, 2])
    primed = gen(n, seed=4, batch=2, seed_codes=seeds, lc=lc, temperature=1.0)
    full = tnet.generate(tparams, n, seed=4, batch=2, gc_ids=[1, 2], lc=lc,
                         seed_codes=seeds, temperature=1.0, include_prime=True)
    assert full.shape == (2, P + n)
    assert torch.equal(primed, full[:, P - 1: P - 1 + n])
    with pytest.raises(ValueError):
        gen(n, batch=2, seed_codes=seeds[:1], lc=lc)          # batch mismatch
