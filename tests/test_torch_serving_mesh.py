"""``Synthesizer(mesh=...)`` in the port: the padded request batch sharded
over the data axis of a one-process mesh of 8 CPU devices, one thread per
shard, against the port's plain synthesizer and JAX's mesh synthesizer
(``tests/test_serving_mesh.py``'s cases, JAX's weights bridged): mel and
linear within 1e-5, waveform lengths equal and samples within 1e-4.

The decode's one collective: each shard runs until every row of every
shard has stopped (``parallel.mesh.ShardReduction`` through
``decoder.scan_autoregressive(all_done=...)``). With rows that stop at
different steps (outputs decaying at per-row rates, as
``test_torch_export.py``), two shards decoded in threads give the
one-device decode of the whole batch, alignments included; a shard
decoded alone stops at its own rows and zeroes alignments the batch
still writes.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.parallel.mesh import make_mesh as j_make_mesh
from nspeech_tpu.serving import Synthesizer as JSynthesizer
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.models import decoder as D
from nspeech_tpu_torch.parallel.mesh import ShardReduction, make_mesh
from nspeech_tpu_torch.serving import Synthesizer

torch.set_num_threads(1)

TEXTS = ["the birch canoe slid", "glue the sheet", "a b c"]
MICRO = ("batch_size=2,max_iters=4,encoder_cbhg_banks=1,post_cbhg_banks=1,"
         "attention_dim=16,decoder_dim=16,embedding_dim=16,griffin_lim_iters=2")


def micro(cfg):
    """``test_serving_mesh.py``'s Tacotron-1 micro config."""
    cfg.parse(MICRO)
    cfg.encoder_prenet = [16, 16]
    cfg.encoder_cbhg_bank_sizes = [16]
    cfg.post_cbhg_bank_sizes = [80]
    cfg.num_speakers = 1
    return cfg


@pytest.fixture(scope="module")
def variables():
    jcfg, tcfg = micro(j_load("taco1")), micro(t_load("taco1"))
    jm, tm = j_create("taco1", jcfg), create_model("taco1", tcfg)
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = convert.tacotron_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    return jcfg, jm, jp, js, tcfg, tm, tp, ts


def port(variables, mesh=None):
    _, _, _, _, tcfg, tm, tp, ts = variables
    return Synthesizer(tcfg, text_bucket=16, device="cpu",
                       mesh=mesh).set_variables(tp, ts, model=tm)


def assert_same(a, b):
    (w0, m0, l0), (w1, m1, l1) = a, b
    assert m1.shape == m0.shape and l1.shape == l0.shape
    np.testing.assert_allclose(m1, m0, atol=1e-5, rtol=0)
    np.testing.assert_allclose(l1, l0, atol=1e-5, rtol=0)
    assert len(w0) == len(w1)
    for x, y in zip(w0, w1):
        assert len(x) == len(y)
        np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)


def test_mesh_serving_matches_single_device_and_jax(variables):
    jcfg, jm, jp, js = variables[:4]
    plain = port(variables).synthesize_batch(TEXTS)
    sharded = port(variables, make_mesh(["cpu"] * 8))
    got = sharded.synthesize_batch(TEXTS)
    assert_same(plain, got)
    jsyn = JSynthesizer(jcfg, text_bucket=16, mesh=j_make_mesh(jax.devices()))
    jsyn.set_variables(jp, js, model=jm)
    assert_same(jsyn.synthesize_batch(TEXTS), got)
    np.testing.assert_allclose(sharded.last_alignment, jsyn.last_alignment,
                               atol=1e-5, rtol=0)
    assert sharded.last_decoder_steps == jsyn.last_decoder_steps


def test_mesh_serving_pads_to_data_axis(variables):
    """One text on an 8-way data axis pads to 8 rows, the padding rows
    finished from the start; a ``model_parallel=2`` mesh still shards the
    batch over its 4 data shards."""
    plain = port(variables)
    one = port(variables, make_mesh(["cpu"] * 8)).synthesize_batch(TEXTS[:1])
    assert len(one[0]) == 1 and one[1].shape[0] == 1 and one[2].shape[0] == 1
    assert_same(plain.synthesize_batch(TEXTS[:1]), one)
    mesh42 = make_mesh(["cpu"] * 8, model_parallel=2)
    assert mesh42.shape == {"data": 4, "model": 2}
    assert_same(plain.synthesize_batch(TEXTS),
                port(variables, mesh42).synthesize_batch(TEXTS))


def decaying_step(model, params, bn, ids, lengths, rates):
    """The decoder step and carry of ``ids``, row r's output at its k-th
    step scaled by ``rates[r] ** k`` (as ``test_torch_export.py``)."""
    ctx, carry0 = model.attention_context(params, bn, ids, lengths)
    raw = model.make_eval_step(params, ctx)

    def step(carry, x):
        cell, k = carry
        cell, (out, align) = raw(cell, x)
        return (cell, k + 1), (out * (rates ** k)[:, None], align)

    return step, (carry0, torch.zeros(ids.shape[0]))


def test_sharded_decode_runs_until_every_shard_stops():
    """Rows 0-1 (shard 0) decay fast, rows 2-3 (shard 1) slowly: at a
    threshold where every row stops, at different steps, the two shards
    in threads equal the decode of the whole batch on one device, and
    shard 0 alone zeroes alignments that the whole batch writes."""
    cfg = t_load("taco2").parse(
        "max_iters=12,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=16,encoder_lstm_units=8,expand_lstm_units=8,"
        "embedding_dim=16")
    model = create_model("taco2", cfg)
    params, bn = model.init(3)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 40, (4, 12)))
    lengths = torch.tensor([12, 9, 12, 7])
    rates = torch.tensor([0.2, 0.25, 0.6, 0.65])

    def decode(rows, threshold, all_done=None):
        step, carry0 = decaying_step(model, params, bn, ids[rows],
                                     lengths[rows], rates[rows])
        with torch.no_grad():
            return D.scan_autoregressive(
                step, carry0, len(range(4)[rows]), cfg.num_mels,
                cfg.outputs_per_step, cfg.max_iters, threshold,
                check_every=2, all_done=all_done)

    outs, _, _ = decode(slice(0, 4), 0.0)
    # the slowest row's peak |output| at step 8: every row stops by then
    threshold = float(outs.abs().amax(dim=-1)[8, 3])
    ref = decode(slice(0, 4), threshold)
    assert len(set(ref[2].tolist())) > 1 and max(ref[2]) < cfg.max_iters

    reduction = ShardReduction(2)
    got = [None, None]

    def work(i):
        got[i] = decode(slice(2 * i, 2 * i + 2), threshold,
                        lambda flags: reduction.all(i, flags))

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for k, axis in enumerate((1, 1, 0)):    # outputs, alignments, steps
        torch.testing.assert_close(torch.cat([got[0][k], got[1][k]], axis),
                                   ref[k], rtol=1e-6, atol=1e-6)
    alone = decode(slice(0, 2), threshold)
    assert max(alone[2]) < max(ref[2])
    assert not torch.equal(alone[1], ref[1][:, :2])


def test_shard_reduction_under_frequent_thread_switches():
    """16 shards (more threads than cores), 200 rounds of random flags,
    a switch interval of 1 us: every shard gets every round's AND, so a
    shard that wrote its next round's flags before another read would
    show."""
    import sys

    shards, rounds = 16, 200
    flags = np.random.default_rng(0).random((rounds, shards, 3)) < 0.9
    want = flags.all(axis=1)
    reduction = ShardReduction(shards)
    got = [[None] * rounds for _ in range(shards)]

    def work(i):
        for r in range(rounds):
            got[i][r] = reduction.all(i, torch.from_numpy(flags[r, i]))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    for i in range(shards):
        np.testing.assert_array_equal(np.stack(got[i]), want)


def test_a_failing_shard_releases_the_others(variables, monkeypatch):
    """Shard 2 of 4 raises before the decode's first reduction: the
    others leave their barrier and the request raises shard 2's error."""
    syn = port(variables, make_mesh(["cpu"] * 4))
    real = syn._decode

    def flaky(params, bn_state, device, ids, lengths, spk, rows, n, all_done=None):
        if rows.start == 2:
            raise RuntimeError("shard 2 failed")
        return real(params, bn_state, device, ids, lengths, spk, rows, n, all_done)

    monkeypatch.setattr(syn, "_decode", flaky)
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        syn.synthesize_batch(TEXTS)
