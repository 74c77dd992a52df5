"""The port's Tacotron-1 eval forward against the JAX package's, at a tiny
width (2-bank CBHGs, 32-wide attention and decoder; the CBHGs' 128-wide
GRUs and highways are fixed by the model): mel, linear, alignments and
per-row decoder steps for every attention type, with a speaker table, with
the serving attention window, and with early stop at rows' different
steps; a batch-padding row of length 0 in every batch.

Tolerance: 1e-4 on mel/linear/alignments (float32 through the decoder's
GRUs and attention, sums in another order), as the Tacotron-2 test;
decoder steps exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models.attention import ATTENTION_TYPES
from nspeech_tpu.models.tacotron import Tacotron1 as JTaco1
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import create_model
from nspeech_tpu_torch.models import tacotron as t_taco1_mod
from nspeech_tpu_torch.models.tacotron import Tacotron1 as TTaco1

torch.set_num_threads(1)

TINY = ("max_iters=6,encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
        "decoder_dim=32,embedding_dim=32")
TOL = dict(atol=1e-4, rtol=1e-4)


def models(extra=""):
    ov = TINY + ("," + extra if extra else "")
    jm, tm = JTaco1(j_load("taco1").parse(ov)), TTaco1(t_load("taco1").parse(ov))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = convert.tacotron_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    return jm, jp, js, tm, tp, ts


def batch():
    rng = np.random.default_rng(0)
    lengths = np.array([12, 8, 5, 0], np.int32)
    text = rng.integers(2, 60, (4, 12)).astype(np.int32)
    text[np.arange(12)[None, :] >= lengths[:, None]] = 0
    return text, lengths, np.array([0, 2, 1, 0], np.int32)


def run_both(jm, jp, js, tm, tp, ts):
    text, lengths, spk = batch()
    jo, _ = jm.forward(jp, js, jnp.asarray(text), jnp.asarray(lengths),
                       speaker_ids=jnp.asarray(spk), is_training=False)
    to = tm.forward(tp, ts, torch.from_numpy(text).long(),
                    torch.from_numpy(lengths).long(), torch.from_numpy(spk).long())
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        assert to[k].shape == jo[k].shape, k
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(to["decoder_steps"].numpy(),
                                  np.asarray(jo["decoder_steps"]))
    return to


@pytest.mark.parametrize("extra", ["", "num_speakers=3"])
def test_bridge_covers_every_leaf(extra):
    jm, jp, js, tm, tp, ts = models(extra)
    assert isinstance(create_model("taco1", tm.cfg), TTaco1)
    for jtree, ttree in ((jp, tp), (js, ts)):
        jl, tl = jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(ttree)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the port's own init draws the same tree
    mine, mine_s = tm.init(1)
    assert (jax.tree_util.tree_structure((mine, mine_s))
            == jax.tree_util.tree_structure((tp, ts)))
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["post_cbhg"]["stray"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        convert.tacotron_variables(tm, bad, jax.tree_util.tree_map(np.asarray, js))


@pytest.mark.parametrize("extra", [f"attention_type={a}" for a in ATTENTION_TYPES]
                         + ["num_speakers=3", "attention_win_fwd=2"])
def test_eval_forward_matches(extra):
    """No early stop (threshold 0): every real row runs max_iters, the
    padding row of length 0 is finished from the start and emits zeros."""
    to = run_both(*models(extra))
    assert to["decoder_steps"].tolist() == [6, 6, 6, 0]
    assert to["mel_outputs"].shape == (4, 30, 80)
    assert to["linear_outputs"].shape == (4, 30, 1025)
    assert not to["alignments"][3].isnan().any()


def test_early_stop_rows_stop_at_different_steps(monkeypatch):
    """A stop threshold between the rows' per-step output peaks makes some
    rows stop before max_iters while others run on."""
    jm, jp, js, tm, tp, ts = models()
    text, lengths, spk = batch()
    captured = {}
    scan = t_taco1_mod.D.scan_autoregressive

    def capture(*args, **kwargs):
        outs, aligns, steps = scan(*args, **kwargs)
        captured["outs"] = outs
        return outs, aligns, steps

    monkeypatch.setattr(t_taco1_mod.D, "scan_autoregressive", capture)
    tm.forward(tp, ts, torch.from_numpy(text).long(),
               torch.from_numpy(lengths).long(), torch.from_numpy(spk).long())
    monkeypatch.undo()
    peak = captured["outs"].abs().amax(-1).numpy()[:, :3]   # [steps, real rows]
    chosen = None
    levels = np.unique(peak)
    for lo, hi in zip(levels[:-1], levels[1:]):
        if hi - lo < 1e-6:
            continue
        thr = float((lo + hi) / 2)
        below = peak <= thr
        first = [int(np.argmax(below[:, i])) + 1 if below[:, i].any() else 6
                 for i in range(3)]
        if len(set(first)) >= 2 and min(first) < 6:
            chosen = thr
            break
    assert chosen is not None, "no threshold separates the rows' stops"
    to = run_both(*models(f"stop_threshold={chosen}"))
    steps = to["decoder_steps"].tolist()
    assert len(set(steps[:3])) >= 2 and steps[3] == 0
