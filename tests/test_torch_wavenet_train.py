"""The port's WaveNet training against the JAX package's, on the CPU, at
tiny widths (4 x 2 dilations, R = DC = 8, S = 16, Q = 128, lc and gc),
weights bridged with ``convert.wavenet_params``, inputs from numpy seeds.

- ``upsample_window`` and ``batch_lc`` (both layouts): equal to JAX's as
  its train step computes them (jitted: positions times 1/hop, the blend
  one fused multiply-add) bit for bit.
- ``mu_law_encode`` (a sorted search among the code edges): equal to
  JAX's at every edge and 16 float32 steps around it.
- ``forward_train`` logits within 1e-5 of their largest, targets equal;
  the loss with L2 within 1e-5 relative; one-hot and ``scalar_input=True``
  (whose wide first conv is ``conv1d`` here and ``conv_general_dilated``
  in JAX); ``predict_logits`` (one-hot input in both packages) within
  1e-5 of their largest.
- Gradients (loss with L2): each leaf within 1e-5 of its largest entry
  (float32 sums in another order).
- Two steps of ``build_wavenet_train_step`` against JAX's jitted step
  under ``jax_default_matmul_precision=highest``, EMA on, learning rate
  0.002: each step's
  ``grad_norm`` within 1e-5 relative, ``learning_rate`` within 1e-6,
  each leaf's update within 1e-4 of its largest entry, the EMA within
  2e-7 absolute (two float32 steps at its largest entries, ~0.7, plus a
  tenth of the updates' tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu import dsp as jdsp
from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data.wavenet_feeder import WaveNetBatch as JBatch
from nspeech_tpu.models.wavenet import WaveNet as JWaveNet
from nspeech_tpu.ops import upsample as jup
from nspeech_tpu.train import loop as jloop
from nspeech_tpu.train.optim import make_optimizer as j_make_optimizer
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch as TBatch
from nspeech_tpu_torch.dsp import mulaw
from nspeech_tpu_torch.models import WaveNet as TWaveNet
from nspeech_tpu_torch.ops import upsample as tup
from nspeech_tpu_torch.train import loop as tloop
from nspeech_tpu_torch.train.optim import make_optimizer as t_make_optimizer
from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TINY = ("dilations_length=4,dilations_depth=2,residual_channels=8,"
        "dilation_channels=8,skip_channels=16,quantization_channels=128,"
        "lc_channels=20,gc_channels=4,gc_category_cardinality=3,"
        "l2_regularization_strength=0.01")
HOP = 250
L2 = 0.01


def nets(extra=""):
    ov = TINY + ("," + extra if extra else "")
    jc, tc = j_load("wavenet").parse(ov), t_load("wavenet").parse(ov)
    jn, tn = JWaveNet(jc), TWaveNet(tc)
    jp = jn.init(jax.random.PRNGKey(0))
    tp = convert.wavenet_params(tn, jax.tree_util.tree_map(np.asarray, jp))
    return jc, tc, jn, tn, jp, tp


def random_batch(seed, n, window, m=20, frame_lc=True):
    """A window batch: audio in [-0.9, 0.9], speaker ids in [0, 3), and
    frame rows with phases (or per-sample rows)."""
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-0.9, 0.9, (n, window)).astype(np.float32)
    spk = rng.integers(0, 3, n).astype(np.int32)
    if frame_lc:
        frames = (window + HOP - 2) // HOP + 2
        mel = rng.random((n, frames, m), dtype=np.float32)
        return audio, spk, mel, rng.integers(0, HOP, n).astype(np.int32)
    return audio, spk, rng.random((n, window, m), dtype=np.float32), None


def test_upsample_window_and_batch_lc_bit_equal():
    jc = j_load("wavenet")
    for seed, frame_lc in ((0, True), (1, True), (2, False)):
        audio, spk, mel, phase = random_batch(seed, 4, 1777, frame_lc=frame_lc)
        jb = JBatch(audio, spk, mel, phase)
        j = np.asarray(jax.jit(lambda b: jup.batch_lc(b, jc))(jb))
        t = tup.batch_lc(tloop.wavenet_batch_to_device(TBatch(*jb), "cpu"),
                         t_load("wavenet")).numpy()
        assert t.shape == (4, 1777, 20)
        np.testing.assert_array_equal(t, j)
    # phases at both ends and a window past the last row (edge hold)
    mel = np.random.default_rng(3).random((3, 6, 7), dtype=np.float32)
    phase = np.array([0, 1, HOP - 1], np.int32)
    j = np.asarray(jax.jit(jup.upsample_window, static_argnums=(2, 3))(
        mel, phase, HOP, 6 * HOP + 40))
    t = tup.upsample_window(torch.from_numpy(mel), torch.from_numpy(phase),
                            HOP, 6 * HOP + 40).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("q", [128, 256])
def test_mu_law_encode_equal_around_every_edge(q):
    edges = mulaw._code_edges(q)
    bits = edges.view(np.uint32).astype(np.int64)
    keys = np.where(bits >= 0x80000000, -(bits & 0x7FFFFFFF), bits)
    x = mulaw._key_to_f32((keys[:, None] + np.arange(-16, 17)[None]).ravel())
    j = np.asarray(jdsp.mu_law_encode(jnp.asarray(x), q))
    t = mulaw.mu_law_encode(torch.from_numpy(x), q).numpy()
    np.testing.assert_array_equal(t, j)


def close_to_largest(t, j, tol):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= tol * np.abs(j).max(), (err, np.abs(j).max())


@pytest.mark.parametrize("extra", ["", "scalar_input=True"])
def test_forward_train_loss_and_predict_logits_match(extra):
    jc, tc, jn, tn, jp, tp = nets(extra)
    audio, spk, mel, _ = random_batch(4, 2, jn.receptive_field + 300,
                                      frame_lc=False)
    jl, jt = jn.forward_train(jp, jnp.asarray(audio), jnp.asarray(spk),
                              jnp.asarray(mel))
    tl, tt = tn.forward_train(tp, torch.from_numpy(audio),
                              torch.from_numpy(spk), torch.from_numpy(mel))
    assert tl.shape == (2, 300, 128)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    close_to_largest(tl.numpy(), jl, 1e-5)
    jloss, jm = jn.loss(jl, jt, params=jp, l2_strength=L2)
    tloss, tm = tn.loss(tl, tt, params=tp, l2_strength=L2)
    assert sorted(tm) == sorted(jm) == ["l2_loss", "loss", "total_loss"]
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    if extra:
        return  # predict_logits one-hots its codes: one-hot models only
    codes = np.random.default_rng(5).integers(0, 128, (2, 200))
    jlog = jn.predict_logits(jp, jnp.asarray(codes), jnp.asarray(spk),
                             jnp.asarray(mel[:, :200]))
    tlog = tn.predict_logits(tp, torch.from_numpy(codes), torch.from_numpy(spk),
                             torch.from_numpy(mel[:, :200]))
    close_to_largest(tlog.numpy(), jlog, 1e-5)


def test_gradients_match():
    jc, tc, jn, tn, jp, tp = nets()
    audio, spk, mel, phase = random_batch(6, 3, jn.receptive_field + 500)

    def loss_fn(params):
        lc = jup.batch_lc(JBatch(audio, spk, mel, phase), jc)
        logits, targets = jn.forward_train(params, audio, gc_ids=spk, lc=lc)
        return jn.loss(logits, targets, params=params, l2_strength=L2)[0]

    jg = jax.tree_util.tree_leaves(jax.grad(loss_fn)(jp))
    batch = tloop.wavenet_batch_to_device(TBatch(audio, spk, mel, phase), "cpu")
    tg, metrics = tloop.wavenet_grads(tn, tp, batch, tc, use_gc=True,
                                      use_lc=True, l2_strength=L2)
    tg = tree_leaves(tg)
    assert len(tg) == len(jg) and "total_loss" in metrics
    for t, j in zip(tg, jg):
        close_to_largest(t.numpy(), j, 1e-5)


def test_two_train_steps_match_jax_step():
    # a constant learning rate of 0.002: Noam's warm-up would make the
    # first updates (~1e-7) smaller than the rounding of the params
    jc, tc, jn, tn, jp, tp = nets("ema_decay=0.9,decay_learning_rate=False")
    jtx, jsched = j_make_optimizer(jc, "wavenet")
    ttx, tsched = t_make_optimizer(tc, "wavenet")
    batches = [random_batch(7 + i, 2, jn.receptive_field + 400) for i in range(2)]
    with jax.default_matmul_precision("highest"):
        jstep = jloop.build_wavenet_train_step(
            jn, jtx, jc, schedule=jsched, use_gc=True, use_lc=True,
            l2_strength=L2, ema_decay=0.9)
        jstate = jloop.create_state(jn, jtx, jax.random.PRNGKey(0), ema=True)
        tstate = tloop.TrainState(0, tp, {}, ttx.init(tp),
                                  tree_map(torch.clone, tp))
        tstep = tloop.build_wavenet_train_step(
            tn, ttx, tc, schedule=tsched, use_gc=True, use_lc=True,
            l2_strength=L2, ema_decay=0.9)
        assert tloop.create_state(tn, ttx, 0).bn_state == {}
        for i, b in enumerate(batches):
            old_j = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
            old_t = [x.clone() for x in tree_leaves(tstate.params)]
            jstate, jm = jstep(jstate, JBatch(*b), jax.random.PRNGKey(i))
            tstate, tm = tstep(tstate, tloop.wavenet_batch_to_device(TBatch(*b), "cpu"))
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(tm["learning_rate"], float(jm["learning_rate"]),
                                       rtol=1e-6)
            np.testing.assert_allclose(tm["grad_norms"].numpy(),
                                       np.asarray(jm["grad_norms"]), rtol=1e-4,
                                       atol=1e-9)
            jl = jax.tree_util.tree_leaves(jstate.params)
            for t, j, ot, oj in zip(tree_leaves(tstate.params), jl, old_t, old_j):
                close_to_largest((t - ot).numpy(), np.asarray(j) - oj, 1e-4)
            jl = jax.tree_util.tree_leaves(jstate.ema_params)
            for t, j in zip(tree_leaves(tstate.ema_params), jl):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                           atol=2e-7)
    assert tstate.step == 2 and int(jstate.step) == 2
