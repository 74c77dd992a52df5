"""The port's WaveNet, weight bridge and sampler wrapper against the JAX
package, on the CPU (the CUDA kernel itself is held against its plain
version in ``test_torch_gpu.py``, on a card).

Tolerances: teacher-forced logits within 1e-5 (float32, products summed
in another order); generated codes at temperature 0 must be identical
(argmax with the lowest-index tie-break on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models.wavenet import WaveNet as JWaveNet
from nspeech_tpu.ops.pallas.wavenet_gen import generate_pallas
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models.wavenet import WaveNet as TWaveNet
from nspeech_tpu_torch.ops.cuda.wavenet_gen import (HEAD_RANKS,
                                                    CudaWaveNetGenerator,
                                                    head_columns, pack_params)
from nspeech_tpu_torch.ops.philox import gumbel_noise, philox4x32

torch.set_num_threads(1)

TINY = ("dilations_length=3,dilations_depth=2,residual_channels=8,"
        "dilation_channels=8,skip_channels=16,quantization_channels=64")


def nets(extra=""):
    ov = TINY + ("," + extra if extra else "")
    jnet = JWaveNet(j_load("wavenet").parse(ov))
    tnet = TWaveNet(t_load("wavenet").parse(ov))
    jparams = jnet.init(jax.random.PRNGKey(0))
    tparams = convert.wavenet_params(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    return jnet, jparams, tnet, tparams


def _leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("extra", [
    "", "lc_channels=5,gc_channels=4,gc_category_cardinality=3",
    "use_biases=True,gc_channels=3,gc_category_cardinality=3"])
def test_bridge_covers_every_leaf(extra):
    jnet, jparams, tnet, tparams = nets(extra)
    assert _leaves(tparams) == _leaves(jparams)
    for jl, tl in zip(jax.tree_util.tree_leaves(jparams),
                      jax.tree_util.tree_leaves(tparams)):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_bridge_rejects_unknown_and_missing_leaves():
    jnet, jparams, tnet, _ = nets()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["layers"][1]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        convert.wavenet_params(tnet, tree)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    del tree["post2"]
    with pytest.raises(ValueError, match="missing"):
        convert.wavenet_params(tnet, tree)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["causal"] = tree["causal"][:, :10]
    with pytest.raises(ValueError, match="shape"):
        convert.wavenet_params(tnet, tree)


@pytest.mark.parametrize("extra,use_lc,use_gc", [
    ("lc_channels=5", True, False),
    ("gc_channels=4,gc_category_cardinality=3", False, True),
    ("lc_channels=5,gc_channels=4,gc_category_cardinality=4,use_biases=True",
     True, True)])
def test_teacher_forced_logits(extra, use_lc, use_gc):
    jnet, jparams, tnet, tparams = nets(extra)
    rng = np.random.default_rng(0)
    B, T = 3, 40
    codes = rng.integers(0, 64, (B, T)).astype(np.int32)
    lc = rng.random((B, T, 5)).astype(np.float32) if use_lc else None
    gc = np.array([0, 2, 1], np.int32) if use_gc else None
    j = np.asarray(jnet._network_embedded(
        jparams, jnp.asarray(codes),
        None if gc is None else jnet._embed_gc(jparams, jnp.asarray(gc)),
        None if lc is None else jnp.asarray(lc)))
    t = tnet._network_embedded(
        tparams, torch.from_numpy(codes), tnet._embed_gc(tparams, gc),
        None if lc is None else torch.from_numpy(lc)).numpy()
    assert t.shape == j.shape == (B, T - tnet.receptive_field + 1, 64)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch", [1, 3])
def test_generate_matches_scan_and_pallas(batch):
    """Plain generate == WaveNet.generate(T=0) == the Pallas kernel in
    interpret mode, with lc and per-stream gc."""
    jnet, jparams, tnet, tparams = nets(
        "lc_channels=5,gc_channels=4,gc_category_cardinality=3")
    rng = np.random.default_rng(batch)
    n = 24
    lc = rng.random((batch, n, 5)).astype(np.float32)
    gc = np.array([2, 0, 1][:batch], np.int32)
    j = np.asarray(jnet.generate(jparams, n, jax.random.PRNGKey(1),
                                 batch=batch, gc_ids=jnp.asarray(gc),
                                 lc=jnp.asarray(lc), temperature=0.0))
    p = np.asarray(generate_pallas(jnet, jparams, n, batch=batch,
                                   gc_ids=jnp.asarray(gc), lc=jnp.asarray(lc),
                                   deterministic=True, interpret=True))
    t = tnet.generate(tparams, n, batch=batch, gc_ids=gc,
                      lc=torch.from_numpy(lc), temperature=0.0).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, p)


def test_generate_primed_matches_scan():
    jnet, jparams, tnet, tparams = nets()
    seeds = np.random.default_rng(9).integers(0, 64, (2, jnet.receptive_field + 3))
    j = np.asarray(jnet.generate(jparams, 15, jax.random.PRNGKey(1), batch=2,
                                 seed_codes=jnp.asarray(seeds, jnp.int32),
                                 temperature=0.0))
    t = tnet.generate(tparams, 15, batch=2, seed_codes=torch.from_numpy(seeds),
                      temperature=0.0).numpy()
    np.testing.assert_array_equal(t, j)


def test_philox_known_answers():
    """Random123's published Philox4x32-10 test vectors."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
              (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr),
                         *key)
        assert tuple(int(w) for w in got) == want


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_gumbel_sampler_matches_softmax(temperature):
    """Gumbel-max with the sampler's Philox noise draws codes with
    frequencies softmax(logits / T) (chi-square, 40k draws)."""
    logits = torch.tensor([0.3, -1.0, 1.2, 0.0, 0.5, -0.4, 2.0, -2.5])
    n = 40000
    g = gumbel_noise(7, torch.arange(n), 1, 8)[:, 0]
    codes = torch.argmax(logits * (1.0 / temperature) + g, dim=-1)
    counts = np.bincount(codes.numpy(), minlength=8)
    expected = torch.softmax(logits.double() / temperature, -1).numpy() * n
    assert stats.chisquare(counts, expected).pvalue > 1e-3


def test_sampled_generate_is_seeded():
    """At T > 0 the plain generator draws from Philox keyed by the seed:
    the same seed repeats, another seed differs, and each stream has its
    own counter."""
    _, _, tnet, tparams = nets()
    a = tnet.generate(tparams, 30, seed=3, batch=2, temperature=1.0)
    b = tnet.generate(tparams, 30, seed=3, batch=2, temperature=1.0)
    c = tnet.generate(tparams, 30, seed=4, batch=2, temperature=1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])


def test_generator_cpu_path_is_plain_generate():
    jnet, jparams, tnet, tparams = nets(
        "lc_channels=5,gc_channels=4,gc_category_cardinality=3")
    lc = torch.from_numpy(np.random.default_rng(2).random((3, 20, 5)).astype(np.float32))
    gen = CudaWaveNetGenerator(tnet, tparams, gc_ids=[0, 1, 2])
    for temperature in (0.0, 1.0):
        np.testing.assert_array_equal(
            gen(20, seed=5, batch=3, lc=lc, temperature=temperature).numpy(),
            tnet.generate(tparams, 20, seed=5, batch=3, gc_ids=[0, 1, 2],
                          lc=lc, temperature=temperature).numpy())
    with pytest.raises(ValueError):
        gen(20, batch=3)                        # conditioned model needs lc
    with pytest.raises(ValueError):
        gen(20, batch=2, lc=lc)                 # lc batch != batch
    seeds = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (3, 4)))
    np.testing.assert_array_equal(
        gen(20, seed=5, batch=3, lc=lc, seed_codes=seeds).numpy(),
        tnet.generate(tparams, 20, seed=5, batch=3, gc_ids=[0, 1, 2], lc=lc,
                      seed_codes=seeds).numpy())


@pytest.mark.parametrize("extra", ["filter_width=3", "scalar_input=True"])
def test_generator_refuses_unsupported_models(extra):
    tnet = TWaveNet(t_load("wavenet").parse(TINY + "," + extra))
    with pytest.raises(NotImplementedError):
        CudaWaveNetGenerator(tnet, tnet.init(0))


def gate_matrix(p, R):
    """The [L, 2R + M, 2DC] gate matrices over [state | current | lc]
    rebuilt from the kernel's split layout (``wfg_chain`` output-major
    [L, 2DC, 2R + DC] over [state | previous residual | previous gates],
    ``wlc`` [L, M, 2DC])."""
    return torch.cat([p["wfg_chain"][:, :, :2 * R].transpose(1, 2), p["wlc"]],
                     dim=1)


def test_pack_params_layout():
    """The kernel's layout holds the same weights: per layer the chain
    rows [state | current] and the lc rows of the gate matrix, the
    previous layer's dense matrix (output-major) and its fold into this
    layer's gates, and per-speaker biases."""
    _, _, tnet, tparams = nets(
        "lc_channels=5,gc_channels=4,gc_category_cardinality=3")
    p = pack_params(tnet, tparams, [2, 0])
    L, R, DC, S, Q, M = 6, 8, 8, 16, 64, 5
    assert p["wfg_chain"].shape == (L, 2 * DC, 2 * R + DC)
    assert p["wlc"].shape == (L, M, 2 * DC)
    assert p["wdense"].shape == (L, R, DC)
    assert p["bfg"].shape == (L, 2, 2 * DC)
    assert p["head"].shape == (L * DC * S + S * S + S * Q,)
    assert p["dilations"].tolist() == tnet.dilations
    assert all(v.is_contiguous() for v in p.values())
    lp, before = tparams["layers"][4], tparams["layers"][3]
    wfg = gate_matrix(p, R)
    np.testing.assert_array_equal(wfg[4, R:2 * R, DC:].numpy(),
                                  lp["gate"][1].numpy())
    np.testing.assert_array_equal(wfg[4, 2 * R:, :DC].numpy(),
                                  lp["lc_filter"][0].numpy())
    # row l of the dense weights is layer l - 1's, folded into layer l
    np.testing.assert_array_equal(p["wdense"][4].T.numpy(),
                                  before["dense"][0].numpy())
    assert not p["wdense"][0].any() and not p["wfg_chain"][0, :, 2 * R:].any()
    wcur = torch.cat([lp["filter"][1], lp["gate"][1]], dim=1)
    np.testing.assert_allclose(p["wfg_chain"][4, :, 2 * R:].T.numpy(),
                               (before["dense"][0] @ wcur).numpy(), atol=1e-6)
    gc = tparams["gc_embedding"][2]
    np.testing.assert_allclose(p["bfg"][4, 0, :DC].numpy(),
                               (gc @ lp["gc_filter"][0]).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="gc ids"):
        pack_params(tnet, tparams, [0, 3])        # the table has 3 rows


@pytest.mark.parametrize("extra", ["", "lc_channels=5",
                                   "lc_channels=80,use_biases=True"])
def test_pack_params_split_rebuilds_gate_matrix(extra):
    """``wfg_chain`` and ``wlc`` together are exactly the one [2R + M, 2DC]
    matrix per layer over [state | current | lc] that the sampler's input
    row multiplies (M = 0 without local conditioning)."""
    _, _, tnet, tparams = nets(extra)
    p = pack_params(tnet, tparams)
    M = tnet.lc_channels
    for l, lp in enumerate(tparams["layers"]):
        rows = [torch.cat([lp["filter"][0], lp["gate"][0]], dim=1),
                torch.cat([lp["filter"][1], lp["gate"][1]], dim=1)]
        if M:
            rows.append(torch.cat([lp["lc_filter"][0], lp["lc_gate"][0]], dim=1))
        want = torch.cat(rows, dim=0)
        got = gate_matrix(p, tnet.residual_channels)[l]
        assert got.shape == (2 * tnet.residual_channels + M,
                             2 * tnet.dilation_channels)
        assert torch.equal(got, want)


def unpack_head(head, K, S, Q):
    """W_skip [K, S], post1 [S, S] and post2 [S, Q] from the packed head,
    head rank by head rank."""
    wskip, post1, post2 = (torch.full(shape, float("nan"))
                           for shape in ((K, S), (S, S), (S, Q)))
    o = 0
    for h in range(HEAD_RANKS):
        cs, qs = head_columns(S, h), head_columns(Q, h)
        for m, cols in ((wskip, cs), (post1, cs), (post2, qs)):
            block = m[:, cols]
            m[:, cols] = head[o:o + block.numel()].reshape(block.shape)
            o += block.numel()
    assert o == head.numel()
    return wskip, post1, post2


@pytest.mark.parametrize("skip,quant", [(16, 64), (512, 256), (20, 12)])
def test_pack_params_head_blocks_cover_the_head(skip, quant):
    """The head's weights are packed as the cluster's head ranks stream
    them (each rank's columns of W_skip, post1 and post2, contiguous); the
    blocks hold every weight once, at widths that split unevenly too."""
    _, _, tnet, tparams = nets(f"skip_channels={skip},quantization_channels={quant}")
    p = pack_params(tnet, tparams)
    want = torch.cat([lp["skip"][0] for lp in tparams["layers"]], dim=0)
    wskip, post1, post2 = unpack_head(p["head"], want.shape[0], skip, quant)
    assert torch.equal(wskip, want)
    assert torch.equal(post1, tparams["post1"][0])
    assert torch.equal(post2, tparams["post2"][0])
