"""The port's Tacotron-2 eval forward against the JAX package's, at a tiny
width: mel, linear, alignments and per-row decoder steps, with early stop
at rows' different steps and a batch-padding row of length 0.

Tolerance: 1e-4 absolute on mel/linear/alignments (float32 through ~10
decoder steps of LSTMs and attention, sums in another order); decoder
steps exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models.tacotron2 import Tacotron2 as JTaco2
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import tacotron2 as t_taco2_mod
from nspeech_tpu_torch.models.tacotron2 import Tacotron2 as TTaco2

torch.set_num_threads(1)

TINY = ("max_iters=10,encoder_conv_layers=2,postnet_conv_layers=2,"
        "expand_conv_layers=2,encoder_conv_channels=32,attention_dim=32,"
        "postnet_conv_channels=32,expand_conv_channels=32,"
        "decoder_lstm_units=48,encoder_lstm_units=24,expand_lstm_units=24,"
        "embedding_dim=32")
TOL = dict(atol=1e-4, rtol=1e-4)


def models(extra=""):
    ov = TINY + ("," + extra if extra else "")
    jm, tm = JTaco2(j_load("taco2").parse(ov)), TTaco2(t_load("taco2").parse(ov))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = convert.tacotron2_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    return jm, jp, js, tm, tp, ts


def batch(n_real=3):
    rng = np.random.default_rng(0)
    lengths = np.array([12, 8, 5, 0][:n_real] + [0] * (4 - n_real), np.int32)
    text = rng.integers(2, 60, (4, 12)).astype(np.int32)
    text[np.arange(12)[None, :] >= lengths[:, None]] = 0
    return text, lengths, np.array([0, 2, 1, 0], np.int32)


def run_both(jm, jp, js, tm, tp, ts, text, lengths, spk):
    jo, _ = jm.forward(jp, js, jnp.asarray(text), jnp.asarray(lengths),
                       speaker_ids=jnp.asarray(spk), is_training=False)
    to = tm.forward(tp, ts, torch.from_numpy(text).long(),
                    torch.from_numpy(lengths).long(), torch.from_numpy(spk).long())
    return jo, to


def assert_same(jo, to):
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        assert to[k].shape == jo[k].shape, k
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(to["decoder_steps"].numpy(),
                                  np.asarray(jo["decoder_steps"]))


@pytest.mark.parametrize("extra", ["", "num_speakers=3"])
def test_bridge_covers_every_leaf(extra):
    jm, jp, js, tm, tp, ts = models(extra)
    for jtree, ttree in ((jp, tp), (js, ts)):
        jl, tl = jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(ttree)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["postnet"]["stray"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        convert.tacotron2_variables(tm, bad, jax.tree_util.tree_map(np.asarray, js))


@pytest.mark.parametrize("extra", ["", "num_speakers=3"])
def test_eval_forward_matches(extra):
    """No early stop (threshold 0): every real row runs max_iters, the
    padding row of length 0 is finished from the start and emits zeros."""
    jm, jp, js, tm, tp, ts = models(extra)
    text, lengths, spk = batch()
    jo, to = run_both(jm, jp, js, tm, tp, ts, text, lengths, spk)
    assert_same(jo, to)
    assert to["decoder_steps"].tolist() == [10, 10, 10, 0]
    assert not to["alignments"][3].isnan().any()


def test_early_stop_rows_stop_at_different_steps(monkeypatch):
    """A stop threshold between the rows' per-step output peaks makes some
    rows stop and others run on (with random weights the peaks grow with
    the step, so a row stops at its first step or never)."""
    jm, jp, js, tm, tp, ts = models()
    text, lengths, spk = batch()
    captured = {}
    scan = t_taco2_mod.D.scan_autoregressive

    def capture(*args, **kwargs):
        outs, aligns, steps = scan(*args, **kwargs)
        captured["outs"] = outs
        return outs, aligns, steps

    monkeypatch.setattr(t_taco2_mod.D, "scan_autoregressive", capture)
    tm.forward(tp, ts, torch.from_numpy(text).long(),
               torch.from_numpy(lengths).long(), torch.from_numpy(spk).long())
    monkeypatch.undo()
    peak = captured["outs"].abs().amax(-1).numpy()[:, :3]   # [steps, real rows]
    levels = np.unique(peak)
    chosen = None
    for lo, hi in zip(levels[:-1], levels[1:]):
        if hi - lo < 1e-6:
            continue
        thr = float((lo + hi) / 2)
        below = peak <= thr
        first = [int(np.argmax(below[:, i])) + 1 if below[:, i].any() else 10
                 for i in range(3)]
        if len(set(first)) >= 2 and min(first) < 10:
            chosen = thr
            break
    assert chosen is not None, "no threshold separates the rows' stops"
    extra = f"stop_threshold={chosen}"
    jm, jp, js, tm, tp, ts = models(extra)
    jo, to = run_both(jm, jp, js, tm, tp, ts, text, lengths, spk)
    assert_same(jo, to)
    steps = to["decoder_steps"].tolist()
    assert len(set(steps[:3])) >= 2 and steps[3] == 0


@pytest.mark.parametrize("check_every", [1, 3, 8])
def test_scan_autoregressive_matches_reference(check_every):
    """The decode loop alone, on a step whose rows decay at different
    rates: rows stop at different steps (5, 9 and 15 here), stopped rows
    emit zeros, a padding row starts finished, and the steps this loop
    runs between host checks past the last stop are zeroed, so the
    buffers equal the reference's while_loop buffers."""
    from nspeech_tpu.models import decoder as JD
    from nspeech_tpu_torch.models import decoder as TD

    rates = np.array([0.3, 0.6, 0.75, 0.5], np.float32)
    ramp = np.linspace(0.2, 1.0, 6, dtype=np.float32)

    def jstep(c, x, _rng):
        out = c[:, None] * ramp[None, :] + 0.0 * x.sum(-1, keepdims=True)
        align = jnp.tile(c[:, None], (1, 5))
        return c * rates, (out, align)

    def tstep(c, x):
        out = c[:, None] * torch.from_numpy(ramp)[None, :] + 0.0 * x.sum(-1, keepdim=True)
        return c * torch.from_numpy(rates), (out, c[:, None].repeat(1, 5))

    init_fin = np.array([False, False, False, True])
    jo, ja, js = JD.scan_autoregressive(
        jstep, jnp.ones(4), 4, 3, 2, 20, stop_threshold=0.02,
        initial_finished=jnp.asarray(init_fin))
    to, ta, ts = TD.scan_autoregressive(
        tstep, torch.ones(4), 4, 3, 2, 20, stop_threshold=0.02,
        initial_finished=torch.from_numpy(init_fin), check_every=check_every)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.tolist() == [5, 9, 15, 0]
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-7)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-7)
