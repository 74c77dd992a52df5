"""The port's training step against the JAX package's, on the CPU, at tiny
widths, on feeder batches of the synthetic corpus (weights bridged with
``convert.tacotron_variables``).

- Training-mode batch norm (padded frames in the moments): output and new
  running statistics within 1e-6.
- The training forward (``drop_rate=0``) of both Tacotrons: mel, linear and
  alignments within 1e-5, the new batch-norm state within 1e-6, the loss
  and every metric within 1e-5 relative, guided attention off and on;
  scheduled sampling at ratio 1.0 (every row fed back, deterministic) the
  same. At ratio 0.5 the share of fed-back rows is within 4 sigma of 0.5
  and the fed-back frame carries no gradient.
- Gradients: the port's autograd against those of JAX's default train
  step (``build_tacotron_train_step``, deferred weight gradients on),
  captured from the step itself by an optax stage that stores them; per
  leaf within 1e-4 of the leaf's largest value (found: 1.3e-5, float32
  sums in another order; ``scripts/torch_train_parity_report.py``). A
  conv bias that feeds batch norm may also be off by up to 1e-6 absolute
  (found: 1.2e-7): its gradient is a sum over every frame that cancels to
  ~1e-3 of its terms, or to exactly 0 where no activation sits between
  the conv and the norm, so relative to its own largest value it is
  rounding noise.
- Clip, Adam, both schedules and the EMA for 3 steps on identical given
  gradients (one case above the clip norm, one below) against
  ``make_optimizer`` and ``_ema_update``: within 1e-6 relative.
- Two steps of JAX's step with its real optimizer against the port's on
  the same two feeder batches: step-2 losses within 1e-4 relative.
- Prenet dropout at 0.5: a kept share within 4 sigma of 0.5, kept values
  scaled by 2, the same mask from the same generator seed.

JAX's train step is compiled twice in this file (once per Tacotron)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.data.feeder import DataFeeder as JFeeder
from nspeech_tpu.models.tacotron import Tacotron1 as JTaco1
from nspeech_tpu.models.tacotron2 import Tacotron2 as JTaco2
from nspeech_tpu.ops import layers as JL
from nspeech_tpu.train import loop as jloop
from nspeech_tpu.train.optim import make_optimizer as j_make_optimizer
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import Tacotron1 as TTaco1
from nspeech_tpu_torch.models import Tacotron2 as TTaco2
from nspeech_tpu_torch.models import decoder as TD
from nspeech_tpu_torch.ops import layers as TL
from nspeech_tpu_torch.train import loop as tloop
from nspeech_tpu_torch.train.optim import make_optimizer as t_make_optimizer
from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map

from tests.make_synth_corpus import make_corpus

torch.set_num_threads(1)

TINY = {
    "taco2": ("encoder_conv_layers=2,postnet_conv_layers=2,expand_conv_layers=2,"
              "encoder_conv_channels=32,attention_dim=32,postnet_conv_channels=32,"
              "expand_conv_channels=32,decoder_lstm_units=32,"
              "encoder_lstm_units=16,expand_lstm_units=16,embedding_dim=32"),
    "taco1": ("encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
              "decoder_dim=32,embedding_dim=32"),
}
BATCH = "batch_size=2,batch_group_size=2,drop_rate=0.0"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n=6)


def configs(name, extra=""):
    ov = ",".join(x for x in (TINY[name], BATCH, extra) if x)
    return j_load(name).parse(ov), t_load(name).parse(ov)


def models(name, extra=""):
    jc, tc = configs(name, extra)
    jm, tm = ((JTaco2(jc), TTaco2(tc)) if name == "taco2"
              else (JTaco1(jc), TTaco1(tc)))
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = convert.tacotron_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    return jm, jp, js, tm, tp, ts


@pytest.fixture(scope="module")
def batches(corpus):
    """Two feeder batches (numpy) of the corpus, for both packages."""
    jc, _ = configs("taco2")
    it = JFeeder({"ljspeech": corpus}, jc, seed=0).epoch_batches(0)
    return [next(it), next(it)]


def t_batch(b):
    return tloop.batch_to_device(b, "cpu")


def close_rel(a, b, rtol):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)


def test_training_batch_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, 8)).astype(np.float32) * 2.0 + 0.5
    x[1, 6:] = 0.0          # padded frames take part in the moments
    x[2, 3:] = 0.0
    p, s = JL.init_batch_norm(8)
    p = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
         "offset": jnp.asarray(rng.standard_normal(8), jnp.float32)}
    s = {"mean": jnp.asarray(rng.standard_normal(8), jnp.float32),
         "var": jnp.asarray(rng.uniform(0.5, 2.0, 8), jnp.float32)}
    jy, jns = JL.batch_norm(p, s, jnp.asarray(x), True)
    tp = tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    ts = tree_map(lambda a: torch.tensor(np.asarray(a)), s)
    ty, tns = TL.batch_norm(tp, ts, torch.from_numpy(x), True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]),
                                   atol=1e-6, rtol=0)
    # inference keeps the running statistics and returns the tensor alone
    assert isinstance(TL.batch_norm(tp, ts, torch.from_numpy(x)), torch.Tensor)


@pytest.mark.parametrize("name,extra", [
    ("taco2", ""), ("taco2", "guided_attention_weight=0.5"),
    ("taco2", "scheduled_sampling_ratio=1.0"),
    ("taco1", ""), ("taco1", "guided_attention_weight=0.5"),
    ("taco1", "scheduled_sampling_ratio=1.0"),
])
def test_training_forward_and_loss_match(batches, name, extra):
    jm, jp, js, tm, tp, ts = models(name, extra)
    b = batches[0]
    jo, jns = jm.forward(jp, js, jnp.asarray(b.inputs),
                         jnp.asarray(b.input_lengths),
                         speaker_ids=jnp.asarray(b.speaker_ids),
                         mel_targets=jnp.asarray(b.mel_targets),
                         is_training=True, rng=jax.random.PRNGKey(1))
    jloss, jmet = jm.loss(jo, jnp.asarray(b.mel_targets),
                          jnp.asarray(b.linear_targets))
    tb = t_batch(b)
    to, tns = tm.forward_train(tp, ts, tb.inputs, tb.input_lengths,
                               tb.speaker_ids, tb.mel_targets, is_training=True)
    tloss, tmet = tm.loss(to, tb.mel_targets, tb.linear_targets)
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        assert to[k].shape == jo[k].shape, k
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    jl, tl = jax.tree_util.tree_leaves(jns), tree_leaves(tns)
    assert len(jl) == len(tl) > 0
    for a, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    assert set(tmet) == set(jmet)
    assert ("loss_guided_attention" in tmet) == ("guided" in extra)
    for k in jmet:
        close_rel(tmet[k], jmet[k], 1e-5)
    close_rel(tloss, jloss, 1e-5)


def test_scheduled_sampling_share_and_no_gradient():
    """Ratio 0.5: each (step, row) feeds back the model's frame with
    probability 0.5; the fed-back frame is detached."""
    steps, rows, m = 200, 16, 3
    teacher = torch.ones(steps, rows, m)
    w = torch.tensor(-2.0, requires_grad=True)
    seen = []

    def step(carry, x):
        seen.append((x[:, 0].clone(), x.requires_grad))
        return carry, (w * torch.ones(rows, m), torch.zeros(rows, 1))

    gen = torch.Generator().manual_seed(0)
    TD.scan_teacher(step, None, teacher, 0.5, gen)
    fed = torch.stack([x for x, _ in seen[1:]]) == -2.0   # step 0 feeds GO/teacher
    n = fed.numel()
    share = fed.float().mean().item()
    assert abs(share - 0.5) <= 4 * (0.25 / n) ** 0.5, share
    assert not any(rg for _, rg in seen)


def capture(tx):
    """An optax stage in front of ``tx`` that stores the gradients it is
    given in its state (so the JAX step's own gradients can be read)."""
    def init(params):
        return ({"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
                tx.init(params))

    def update(g, state, params=None):
        u, s = tx.update(g, state[1], params)
        return u, ({"g": g}, s)

    return optax.GradientTransformation(init, update)


def t_state(tm, tp, ts, tc, name):
    opt, sched = t_make_optimizer(tc, name)
    return tloop.TrainState(0, tp, ts, opt.init(tp)), opt, sched


@pytest.mark.parametrize("name", ["taco2", "taco1"])
def test_gradients_and_two_steps_match_jax_default_step(batches, name):
    jm, jp, js, tm, tp, ts = models(name)
    jc, tc = configs(name)
    jtx, jsched = j_make_optimizer(jc, name)
    jstep = jloop.build_tacotron_train_step(jm, capture(jtx), schedule=jsched)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), jp, js,
                              capture(jtx).init(jp))
    tstate, topt, tsched = t_state(tm, tp, ts, tc, name)
    tstep = tloop.build_tacotron_train_step(tm, topt, schedule=tsched)

    tgrads, tmet, _ = tloop.tacotron_grads(tm, tstate, t_batch(batches[0]), None)
    jstate, jmet = jstep(jstate, batches[0], jax.random.PRNGKey(1))
    jgrads = jax.tree_util.tree_leaves_with_path(jstate.opt_state[0]["g"])
    tleaves = tree_leaves(tgrads)
    assert len(jgrads) == len(tleaves)
    for (path, j), t in zip(jgrads, tleaves):
        j = np.asarray(j)
        bound = 1e-4 * np.abs(j).max()
        if jax.tree_util.keystr(path).endswith("['conv']['bias']"):
            bound = max(bound, 1e-6)
        err = np.abs(t.numpy() - j).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)
    close_rel(tmet["loss"], jmet["loss"], 1e-5)
    np.testing.assert_allclose(
        tloop.leaf_norms(tgrads).numpy(), np.asarray(jmet["grad_norms"]),
        rtol=1e-4, atol=1e-6)   # the atol: the conv biases above

    if name != "taco2":
        return
    tstate, _ = tstep(tstate, t_batch(batches[0]), None)
    jstate, jmet = jstep(jstate, batches[1], jax.random.PRNGKey(2))
    tstate, tmet = tstep(tstate, t_batch(batches[1]), None)
    close_rel(tmet["loss"], jmet["loss"], 1e-4)
    assert tstate.step == 2 and int(jstate.step) == 2
    close_rel(tmet["learning_rate"], jmet["learning_rate"], 1e-6)


@pytest.mark.parametrize("name,scale", [
    ("taco2", 10.0),   # global norm above the clip (1.0): clipped
    ("taco1", 0.01),   # below: passed through
])
def test_optimizer_and_ema_match_optax(name, scale):
    jc, tc = configs(name, "ema_decay=0.9")
    jtx, _ = j_make_optimizer(jc, name)
    topt, _ = t_make_optimizer(tc, name)
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32)]}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jstate, tstate = jtx.init(jp), topt.init(tp)
    jema, tema = jp, tree_map(torch.clone, tp)
    for _ in range(3):
        g = tree_map(lambda a: (scale * rng.standard_normal(a.shape)
                                ).astype(np.float32), params)
        ju, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, jp)
        jp = optax.apply_updates(jp, ju)
        jema = jloop._ema_update(jema, jp, 0.9)
        tu, tstate = topt.update(tree_map(torch.from_numpy, g), tstate)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        tema = tloop.ema_update(tema, tp, 0.9)
        for j, t in zip(jax.tree_util.tree_leaves(ju), tree_leaves(tu)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6 * np.abs(np.asarray(j)).max())
        for tree_j, tree_t in ((jp, tp), (jema, tema)):
            for j, t in zip(jax.tree_util.tree_leaves(tree_j),
                            tree_leaves(tree_t)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=1e-7)


def test_prenet_dropout_share_scale_and_seed():
    rng = np.random.default_rng(0)
    params = TL.init_prenet(rng, 8, [256, 128])
    x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    clean = TL.prenet(params, x)
    out = TL.prenet(params, x, 0.5, torch.Generator().manual_seed(7))
    again = TL.prenet(params, x, 0.5, torch.Generator().manual_seed(7))
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    # the first layer's mask, seen through a one-layer prenet
    one = {"layers": params["layers"][:1]}
    h = TL.prenet(one, x)
    d = TL.prenet(one, x, 0.5, torch.Generator().manual_seed(7))
    live = h > 0
    kept = (d > 0) & live
    share = kept.sum().item() / live.sum().item()
    n = live.sum().item()
    assert abs(share - 0.5) <= 4 * (0.25 / n) ** 0.5, share
    torch.testing.assert_close(d[kept], 2.0 * h[kept])
    assert not torch.equal(out, clean)
    # no generator or rate 0: no dropout
    torch.testing.assert_close(TL.prenet(params, x, 0.5, None), clean)
    torch.testing.assert_close(
        TL.prenet(params, x, 0.0, torch.Generator().manual_seed(7)), clean)
