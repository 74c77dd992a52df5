"""The port's bf16 compute policy (``nspeech_tpu_torch/ops/policy.py``)
against the JAX package's (``nspeech_tpu/ops/policy.py``, held by
``tests/test_mixed_precision.py``), on the CPU, at that test's tiny widths,
weights bridged from JAX's init, inputs from numpy seeds.

- Cast rules: float32 by default, bfloat16 by name, a non-float name
  refused; integer and bool leaves and ``None`` pass; the one-launch flat
  cast gives the leafwise cast's values; gradients reach float32 masters
  through it.
- Teacher-forced forwards (Tacotron-1, Tacotron-2) and WaveNet's training
  logits at ``compute_dtype=bfloat16``: in bf16, within JAX's own bound
  (atol 0.05, rtol 0.05) of JAX's float32 forward on the same weights, and
  their largest gap to it at most ``GAP_FACTOR`` (2) times JAX's bf16
  forward's (found: 0.60-1.37 times). The two bf16 forwards cannot agree
  bit for bit: XLA keeps float32 inside its fused elementwise chains, and
  PyTorch's eager operations round to bf16 after each one. WaveNet's targets are
  identical; batch-norm statistics stay float32.
- A free-running bf16 decode stays finite and bf16 (JAX's
  ``test_bf16_autoregressive_decode_runs``).
- One bf16 train step of each model keeps float32 masters and optimizer
  state, and its loss is within 2e-2 relative of JAX's bf16 loss on the
  same weights and batch (the loss JAX's step reports).
- ``compute_dtype=float32`` is the port before the policy, bit for bit:
  a float32 forward, loss and gradient equal those of a run with every
  policy hook replaced by the identity.
- A bf16 checkpoint serves on the CPU through ``Synthesizer``,
  ``TextToSpeech`` (Tacotron-1 and -2, the plain sampler) and
  ``StreamingTTS``, with float32 mels into Griffin-Lim and the vocoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nspeech_tpu.config import load_config as j_load
from nspeech_tpu.models import create_model as j_create
from nspeech_tpu.models.wavenet import WaveNet as JWaveNet
from nspeech_tpu_torch import convert
from nspeech_tpu_torch.config import load_config as t_load
from nspeech_tpu_torch.models import WaveNet as TWaveNet
from nspeech_tpu_torch.models import attention as TA
from nspeech_tpu_torch.models import create_model as t_create
from nspeech_tpu_torch.models import wavenet as TW
from nspeech_tpu_torch.ops import layers as TL
from nspeech_tpu_torch.ops import policy
from nspeech_tpu_torch.serving import StreamingTTS, Synthesizer, TextToSpeech
from nspeech_tpu_torch.serving import WaveNetVocoder
from nspeech_tpu_torch.train import loop as tloop
from nspeech_tpu_torch.train.checkpoint import CheckpointManager
from nspeech_tpu_torch.train.optim import make_optimizer
from nspeech_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

GAP_FACTOR = 2.0
TINY = {
    "taco1": ("encoder_cbhg_banks=2,post_cbhg_banks=2,max_iters=4,"
              "attention_dim=32,decoder_dim=32,embedding_dim=32,batch_size=4"),
    "taco2": ("max_iters=4,attention_dim=32,decoder_lstm_units=32,"
              "encoder_lstm_units=16,encoder_conv_channels=32,"
              "expand_lstm_units=16,expand_conv_channels=32,"
              "postnet_conv_channels=32,embedding_dim=32,batch_size=4"),
    "wavenet": ("dilations_length=3,dilations_depth=1,residual_channels=8,"
                "dilation_channels=8,skip_channels=16,"
                "quantization_channels=64,batch_size=4"),
}
BF16 = ",compute_dtype=bfloat16"


def configs(name, extra=""):
    jc, tc = j_load(name).parse(TINY[name] + extra), t_load(name).parse(TINY[name] + extra)
    if name == "taco1":
        for c in (jc, tc):
            c.encoder_prenet = [32, 16]
            c.encoder_cbhg_bank_sizes = [32, 16]
            c.post_cbhg_bank_sizes = [32]
    return jc, tc


def tacotrons(name, extra=""):
    """(JAX model, JAX variables, port model, port variables) on one init."""
    jc, tc = configs(name, extra)
    jm, tm = j_create(name, jc), t_create(name, tc)
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = convert.tacotron_variables(
        tm, jax.tree_util.tree_map(np.asarray, jp),
        jax.tree_util.tree_map(np.asarray, js))
    return jm, (jp, js), tm, (tp, ts)


def batch(seed=0, n=4, t_in=10, t_out=10):
    rng = np.random.default_rng(seed)
    return dict(inputs=rng.integers(2, 60, (n, t_in)).astype(np.int32),
                lengths=np.full((n,), t_in, np.int32),
                speakers=np.zeros((n,), np.int32),
                mel=rng.random((n, t_out, 80), dtype=np.float32),
                linear=rng.random((n, t_out, 1025), dtype=np.float32))


def j_forward(jm, jv, b, is_training=False):
    return jm.forward(*jv, jnp.asarray(b["inputs"]), jnp.asarray(b["lengths"]),
                      speaker_ids=jnp.asarray(b["speakers"]),
                      mel_targets=jnp.asarray(b["mel"]), is_training=is_training)


def t_forward(tm, tv, b, is_training=False):
    return tm.forward_train(*tv, torch.from_numpy(b["inputs"]).long(),
                            torch.from_numpy(b["lengths"]).long(),
                            torch.from_numpy(b["speakers"]).long(),
                            torch.from_numpy(b["mel"]), is_training=is_training)


def f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def check_close(ours, jax16, jax32, what):
    """The port's bf16 output against JAX's float32 (JAX's bound) and its
    gap against JAX's bf16 gap."""
    ours, jax16, jax32 = f32(ours), f32(jax16), f32(jax32)
    np.testing.assert_allclose(ours, jax32, atol=0.05, rtol=0.05, err_msg=what)
    gap, jgap = np.abs(ours - jax32).max(), np.abs(jax16 - jax32).max()
    assert gap <= GAP_FACTOR * jgap, (what, gap, jgap)


def assert_all_f32(tree, what):
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            assert leaf.dtype == torch.float32, what


# ---------------------------------------------------------------------------
# cast rules
# ---------------------------------------------------------------------------

def test_policy_cast_rules():
    cfg = t_load("taco1")
    assert policy.compute_dtype(cfg) == torch.float32
    cfg.parse("compute_dtype=bfloat16")
    assert policy.compute_dtype(cfg) == torch.bfloat16
    cfg.parse("compute_dtype=int8")
    with pytest.raises(ValueError, match="float dtype"):
        policy.compute_dtype(cfg)

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    tree = {"w": w, "b": [torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
                          torch.tensor(0.3)],
            "ids": torch.ones(2, dtype=torch.int32), "mask": torch.ones(2, dtype=torch.bool),
            "none": None}
    out = policy.cast_floats(tree, torch.bfloat16)
    assert out["w"].dtype == out["b"][0].dtype == out["b"][1].dtype == torch.bfloat16
    assert out["ids"] is tree["ids"] and out["mask"] is tree["mask"]
    assert out["none"] is None and policy.cast_floats(None, torch.bfloat16) is None
    for path in (("w",), ("b", 0), ("b", 1)):
        src, got = tree, out
        for k in path:
            src, got = src[k], got[k]
        assert got.shape == src.shape
        assert torch.equal(got, src.to(torch.bfloat16))     # the leafwise cast
    # nothing to cast: the same objects back, float32 entry leaves the tree
    assert policy.cast_floats(out, torch.bfloat16)["w"] is out["w"]
    assert policy.entry_cast(tree, torch.float32) is tree
    f64 = {"x": torch.ones(2, dtype=torch.float64)}
    assert policy.entry_cast(f64, torch.float32)["x"].dtype == torch.float64

    # the gradient of a bf16 forward reaches float32 masters as float32
    masters = tree_map(lambda t: t.clone().requires_grad_(True), {"w": w, "v": w[0]})
    cast = policy.cast_floats(masters, torch.bfloat16)
    loss = policy.upcast((cast["w"] * cast["v"]).sum())
    loss.backward()
    assert masters["w"].grad.dtype == torch.float32
    torch.testing.assert_close(masters["w"].grad,
                               cast["v"].float().expand(3, 5), rtol=0, atol=0)


def test_acc_dot_accumulates_in_float32():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((16, 1600)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((1600, 24)).astype(np.float32)).bfloat16()
    ref = (a.double() @ b.double()).bfloat16()     # exact sum, one rounding
    got = TL.acc_dot(a, b)
    assert got.dtype == torch.bfloat16
    # within one bf16 ulp of the exactly rounded sum
    ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs().clamp(min=1e-3)
    assert ((got.float() - ref.float()).abs() <= ulp).all()
    x32 = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    w32 = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    assert torch.equal(TL.acc_dot(x32, w32), x32 @ w32)


def test_batch_norm_moments_in_float32():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal((3, 9, 8)) * 3 + 40).astype(np.float32))
    p = {"scale": torch.ones(8), "offset": torch.zeros(8)}
    s = {"mean": torch.zeros(8), "var": torch.ones(8)}
    y16, st16 = TL.batch_norm(policy.cast_floats(p, torch.bfloat16), s,
                              x.bfloat16(), True)
    y32, st32 = TL.batch_norm(p, s, x.bfloat16().float(), True)
    assert y16.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in st16.values())
    torch.testing.assert_close(st16["mean"], st32["mean"], rtol=0, atol=0)
    torch.testing.assert_close(y16, y32.bfloat16(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["taco1", "taco2"])
def test_bf16_forward_close_to_f32(name):
    jm, jv, _, tv = tacotrons(name)
    b = batch()
    j32, _ = j_forward(jm, jv, b)
    jm16, _, tm16, _ = tacotrons(name, BF16)
    j16, _ = j_forward(jm16, jv, b)
    with torch.no_grad():
        t16, new_state = t_forward(tm16, tv, b)
    assert t16["mel_outputs"].dtype == torch.bfloat16
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        check_close(t16[k], j16[k], j32[k], k)
    np.testing.assert_allclose(f32(t16["alignments"]).sum(axis=1), 1.0, atol=0.02)
    assert_all_f32(new_state, "bn_state")
    assert_all_f32(tv, "params")                  # the masters are untouched


def test_bf16_wavenet_logits_close_to_f32():
    jc, tc = configs("wavenet")
    jn, tn = JWaveNet(jc), TWaveNet(tc)
    jp = jn.init(jax.random.PRNGKey(0))
    tp = convert.wavenet_params(tn, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(3)
    audio = rng.uniform(-0.5, 0.5, (2, jn.receptive_field + 16)).astype(np.float32)
    j32, jt32 = jn.forward_train(jp, jnp.asarray(audio))
    jc16, tc16 = configs("wavenet", BF16)
    j16, jt16 = JWaveNet(jc16).forward_train(jp, jnp.asarray(audio))
    with torch.no_grad():
        t16, tt16 = TWaveNet(tc16).forward_train(tp, torch.from_numpy(audio))
    assert t16.dtype == torch.bfloat16
    np.testing.assert_array_equal(tt16.numpy(), np.asarray(jt32))
    np.testing.assert_array_equal(np.asarray(jt16), np.asarray(jt32))
    check_close(t16, j16, j32, "logits")


def test_bf16_autoregressive_decode_runs():
    _, _, tm16, tv = tacotrons("taco2", BF16)
    b = batch()
    out = tm16.forward(*tv, torch.from_numpy(b["inputs"]).long(),
                       torch.from_numpy(b["lengths"]).long(),
                       torch.from_numpy(b["speakers"]).long())
    assert out["mel_outputs"].dtype == torch.bfloat16
    assert torch.isfinite(out["mel_outputs"].float()).all()
    assert out["decoder_steps"].shape == (4,)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["taco1", "taco2"])
def test_bf16_train_step_keeps_f32_masters(name):
    extra = BF16 + ",drop_rate=0.0"
    jm16, jv, tm16, tv = tacotrons(name, extra)
    b = batch(seed=4)
    jo, _ = j_forward(jm16, jv, b, is_training=True)
    jloss, _ = jm16.loss(jo, jnp.asarray(b["mel"]), jnp.asarray(b["linear"]))
    opt, sched = make_optimizer(tm16.cfg, name)
    state = tloop.TrainState(0, tv[0], tv[1], opt.init(tv[0]))
    step = tloop.build_tacotron_train_step(tm16, opt, sched)
    data = tloop.TacotronBatch(*(torch.from_numpy(b[k]).long() for k in
                                 ("inputs", "lengths", "speakers")),
                               torch.from_numpy(b["mel"]), torch.from_numpy(b["linear"]))
    new, metrics = step(state, data, torch.Generator().manual_seed(0))
    assert metrics["loss"].dtype == torch.float32
    assert abs(float(metrics["loss"]) - float(jloss)) <= 2e-2 * abs(float(jloss))
    assert float(metrics["grad_norm"]) > 0.0
    assert_all_f32(new.params, "params")
    assert_all_f32(new.opt_state, "opt_state")
    assert_all_f32(new.bn_state, "bn_state")
    assert new.step == 1


def test_bf16_wavenet_train_step_keeps_f32_masters():
    from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch

    jc, tc = configs("wavenet", BF16)
    jn, tn = JWaveNet(jc), TWaveNet(tc)
    jp = jn.init(jax.random.PRNGKey(0))
    tp = convert.wavenet_params(tn, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(5)
    audio = rng.uniform(-0.5, 0.5, (4, jn.receptive_field + 32)).astype(np.float32)
    logits, targets = jn.forward_train(jp, jnp.asarray(audio))
    jloss, _ = jn.loss(logits, targets)
    opt, sched = make_optimizer(tc, "wavenet")
    step = tloop.build_wavenet_train_step(tn, opt, tc, sched)
    state = tloop.TrainState(0, tp, {}, opt.init(tp))
    b = WaveNetBatch(audio=audio, speaker_ids=np.zeros(4, np.int32),
                     mel=np.zeros((4, 1, 80), np.float32), mel_phase=None)
    losses = []
    for _ in range(3):
        state, metrics = step(state, tloop.wavenet_batch_to_device(b, "cpu"))
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - float(jloss)) <= 2e-2 * abs(float(jloss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert_all_f32(state.params, "params")
    assert_all_f32(state.opt_state, "opt_state")


# ---------------------------------------------------------------------------
# float32 is the port before the policy
# ---------------------------------------------------------------------------

def _identity_hooks(monkeypatch):
    """Every policy hook the float32 path passes through, as the identity
    or the plain product: the arithmetic of the port before the policy."""
    ident = lambda x, *a: x  # noqa: E731
    monkeypatch.setattr(policy, "entry_cast", ident)
    monkeypatch.setattr(policy, "upcast", ident)
    monkeypatch.setattr(TL, "upcast", ident)
    monkeypatch.setattr(TA, "upcast", ident)
    monkeypatch.setattr(TL, "acc_dot", lambda x, w: x @ w)
    monkeypatch.setattr(TW, "acc_dot", lambda x, w: x @ w)
    monkeypatch.setattr(TL, "acc_einsum", torch.einsum)


def _f32_run(name):
    torch.manual_seed(0)
    if name == "wavenet":
        jc, tc = configs("wavenet", ",lc_channels=20")
        tn = TWaveNet(tc)
        tp = tloop.trainable(tn.init(0))
        rng = np.random.default_rng(6)
        audio = torch.from_numpy(
            rng.uniform(-0.5, 0.5, (2, tn.receptive_field + 16)).astype(np.float32))
        lc = torch.from_numpy(rng.random((2, tn.receptive_field + 16, 20),
                                         dtype=np.float32))
        logits, targets = tn.forward_train(tp, audio, lc=lc)
        loss, _ = tn.loss(logits, targets, params=tp, l2_strength=0.01)
        outs = [logits]
    else:
        _, _, tm, (tp, ts) = tacotrons(name, ",guided_attention_weight=0.5")
        tp = tloop.trainable(tp)
        b = batch(seed=7)
        out, new_bn = t_forward(tm, (tp, ts), b, is_training=True)
        loss, _ = tm.loss(out, torch.from_numpy(b["mel"]), torch.from_numpy(b["linear"]))
        outs = [out[k] for k in sorted(out)] + tree_leaves(new_bn)
    grads = tloop.autograd_grads(loss, tp)
    return [t.detach() for t in outs + [loss] + tree_leaves(grads)]


@pytest.mark.parametrize("name", ["taco1", "taco2"])
def test_float64_default_dtype_is_kept(name):
    """Under the default float32 policy a float64 run (parameters, inputs
    and ``torch.set_default_dtype(torch.float64)``, as the card-against-CPU
    checks run) stays float64: the decoder's zero carries and GO frame
    follow torch's default dtype."""
    _, _, tm, (tp, ts) = tacotrons(name)
    b = batch(seed=8)
    to64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    torch.set_default_dtype(torch.float64)
    try:
        out, _ = tm.forward_train(
            tree_map(to64, tp), tree_map(to64, ts),
            torch.from_numpy(b["inputs"]).long(), torch.from_numpy(b["lengths"]).long(),
            torch.from_numpy(b["speakers"]).long(),
            torch.from_numpy(b["mel"]).double(), is_training=False)
        inf = tm.forward(tree_map(to64, tp), tree_map(to64, ts),
                         torch.from_numpy(b["inputs"]).long(),
                         torch.from_numpy(b["lengths"]).long(),
                         torch.from_numpy(b["speakers"]).long())
    finally:
        torch.set_default_dtype(torch.float32)
    assert out["mel_outputs"].dtype == out["alignments"].dtype == torch.float64
    assert inf["mel_outputs"].dtype == torch.float64


@pytest.mark.parametrize("name", ["taco1", "taco2", "wavenet"])
def test_float32_is_unchanged_bit_for_bit(name, monkeypatch):
    ours = _f32_run(name)
    with monkeypatch.context() as m:
        _identity_hooks(m)
        before = _f32_run(name)
    assert len(ours) == len(before)
    for a, b in zip(ours, before):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving a bf16 checkpoint
# ---------------------------------------------------------------------------

VOC = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
       "dilation_channels=8,skip_channels=16,quantization_channels=64,"
       "lc_channels=80")


@pytest.fixture(scope="module")
def vocoder():
    cfg = t_load("wavenet").parse(VOC + BF16)
    net = TWaveNet(cfg)
    return WaveNetVocoder(cfg, device="cpu").set_variables(net, net.init(1))


@pytest.mark.parametrize("name", ["taco1", "taco2"])
def test_bf16_checkpoint_serves(name, tmp_path, vocoder):
    _, tc = configs(name, BF16 + ",griffin_lim_iters=3")
    model = t_create(name, tc)
    opt, sched = make_optimizer(tc, name)
    state = tloop.create_state(model, opt, 0)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), name, tc)
    ckpt.save(3, state)
    synth = Synthesizer.from_checkpoint(str(tmp_path / "ckpt"), text_bucket=16,
                                        device="cpu")
    assert synth.cfg.compute_dtype == "bfloat16"
    assert synth._params["embedding"]["table"].dtype == torch.bfloat16
    assert_all_f32(synth._bn_state, "bn_state")
    wav, mel, lin = synth.synthesize("hello")
    assert wav.dtype == mel.dtype == lin.dtype == np.float32
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
    assert np.isfinite(mel).all() and np.isfinite(lin).all()
    tts = TextToSpeech(synth, vocoder)
    wav, mel, _ = tts.synthesize("hello", temperature=0.0)
    assert wav.dtype == np.float32 and np.isfinite(wav).all() and len(wav) > 0
    wavs, mels, _ = tts.synthesize_batch(["hello", "a b"], temperature=0.0)
    assert len(wavs) == 2 and all(np.isfinite(w).all() for w in wavs)
    stream = StreamingTTS(synth, vocoder, chunk_frames=4, temperature=0.0,
                          text_bucket=16)
    chunks = list(stream.stream("hello"))
    assert chunks and all(c.dtype == np.float32 and np.isfinite(c).all()
                          for c in chunks)


def test_bf16_wavenet_cli_trains_and_serves(tmp_path, capsys):
    """``cli.train_wavenet --hparams compute_dtype=bfloat16``: float32
    masters in the checkpoint, finite losses, and the bf16 run's vocoder
    generates through the float32 sampler path."""
    from nspeech_tpu_torch.cli import generate_wavenet as gen_cli
    from nspeech_tpu_torch.cli import train_wavenet as wn_cli
    from tests.make_synth_corpus import make_corpus

    corpus = make_corpus(str(tmp_path / "corpus"), n=4)
    wn_cli.main(["--device", "cpu", "--ljspeech", corpus, "--log-dir",
                 str(tmp_path), "--max-steps", "2", "--checkpoint-interval", "2",
                 "--hparams", "batch_size=2,sample_size=512,dilations_length=4,"
                 "dilations_depth=2,residual_channels=8,dilation_channels=8,"
                 "skip_channels=16,quantization_channels=128,lc_channels=80"
                 + BF16])
    assert "compute dtype bfloat16" in capsys.readouterr().out
    ckpt = tmp_path / "wavenet" / "ckpt"
    state = torch.load(ckpt / "train" / "2.pt", weights_only=True)
    assert_all_f32(state["params"], "params")
    assert_all_f32(state["opt_state"], "opt_state")
    np.save(tmp_path / "mel.npy", np.random.default_rng(0).random((4, 80),
                                                                  dtype=np.float32))
    out = tmp_path / "v.wav"
    gen_cli.main([str(ckpt), "--device", "cpu", "--samples", "200",
                  "--mel-npy", str(tmp_path / "mel.npy"), "--wav_out_path", str(out)])
    assert out.stat().st_size > 0
