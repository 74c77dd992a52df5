"""The port's WaveNet training against the benchmark's plain reference
(``benchmark/reference/wavenet_train.py``) at small widths on the CPU:
2 x 3 dilated layers, R = DC = 8, S = 16, Q = 32, lc 8, two windows of
the receptive field + 300 samples, seeded random weights.

- ``wavenet_grads`` in float64 against the reference in float64: the
  loss and every gradient leaf.
- Two steps of ``build_wavenet_train_step`` (clip, Adam, the Noam
  schedule) in float64 against the reference's two: each loss and the
  parameters' change, leaf by leaf.
- The reference's pieces the comparison rests on: its mu-law codes equal
  the port's encoder on the whole 16-bit grid, its conditioning the
  port's ``batch_lc``, and its windows ``WaveNetFeeder``'s.
- The reference imports nothing of the port and no JAX module.

The port's step runs on frame-rate rows in float32 alone (its upsampling
rounds to float32), so the float64 runs take the port's per-sample
conditioning widened to float64, and the reference its own from the
same rows.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.reference import dsp as rdsp
from benchmark.reference import wavenet as rwavenet
from benchmark.reference import wavenet_train as rtrain
from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetBatch, WaveNetFeeder
from nspeech_tpu_torch.dsp.mulaw import mu_law_encode
from nspeech_tpu_torch.models import WaveNet
from nspeech_tpu_torch.ops.upsample import batch_lc
from nspeech_tpu_torch.train.loop import (TrainState, WaveNetDeviceBatch,
                                          build_wavenet_train_step,
                                          wavenet_batch_to_device, wavenet_grads)
from nspeech_tpu_torch.train.optim import make_optimizer
from nspeech_tpu_torch.utils.tree import tree_map

SMALL = ("dilations_depth=2,dilations_length=3,residual_channels=8,"
         "dilation_channels=8,skip_channels=16,quantization_channels=32,"
         "lc_channels=8,num_mels=8,sample_size=300,batch_size=2")
# Tolerances, relative. The two sides compute the same float64 arithmetic
# in another order, from conditioning that differs in rounding alone: the
# port's positions are float32 (phase + j) * (1 / hop), the reference's
# float64 (phase + j) / hop, and both round the blend to float32, so a
# few conditioning values lie a float32 ulp (6e-8) apart. That moves the
# loss and gradients by ~1e-8; a tolerance of 1e-6 leaves room for it
# and fails a term of the loss or a gradient path left out (1e-3 and up).
LOSS_TOL = 1e-6
GRAD_TOL = 1e-6
# Adam's step takes its bias corrections 1 - beta^t in float32, as optax
# does: float32(0.999) is 0.99900001, so 1 - beta2 lies 1.3e-5 from the
# float64 value the reference takes, and the step, over its square root,
# ~6.5e-6 (8.8e-6 measured over two steps). 3e-5 leaves room for that and
# fails a wrong moment, correction or rate (1e-2 and up).
CHANGE_TOL = 3e-5


def _cfg():
    return load_config("wavenet").parse(SMALL)


def _batches(cfg, n, seed=3):
    """``n`` feeder-shaped batches: 16-bit-grid samples, frame-rate rows
    with their phases."""
    rng = np.random.default_rng(seed)
    rf = WaveNet(cfg).receptive_field
    rows = rtrain.rows_per_window(cfg.values())
    hop = 250
    out = []
    for _ in range(n):
        audio = rng.integers(-30000, 30000, (cfg.batch_size, rf + cfg.sample_size)) / 32768.0
        out.append(WaveNetBatch(
            audio.astype(np.float32), np.zeros(cfg.batch_size, np.int32),
            rng.uniform(0.0, 1.0, (cfg.batch_size, rows, cfg.num_mels)).astype(np.float32),
            rng.integers(0, hop, cfg.batch_size).astype(np.int32)))
    return out


def _params(cfg, seed=11):
    (p,) = weights.make([rwavenet.param_shapes(cfg.values())], seed, 1, "cpu")
    return tree_map(torch.Tensor.double, p)


def _port64(cfg, batch):
    data = wavenet_batch_to_device(batch, torch.device("cpu"))
    return WaveNetDeviceBatch(data.audio.double(), data.speaker_ids,
                              batch_lc(data, cfg).double(), None)


def _ref(batch):
    return (torch.from_numpy(batch.audio).double(), torch.from_numpy(batch.mel),
            batch.mel_phase.tolist())


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_grads_equal_the_reference():
    cfg = _cfg()
    net = WaveNet(cfg)
    params = _params(cfg)
    (batch,) = _batches(cfg, 1)
    grads, metrics = wavenet_grads(net, params, _port64(cfg, batch), cfg, use_lc=True)
    loss, ref = rtrain.grads(cfg.values(), params, _ref(batch))
    assert abs(float(metrics["loss"]) - loss) <= LOSS_TOL * loss
    port = rtrain.leaves(grads)
    assert len(port) == len(ref) == 3 + 2 * 3 * 6     # causal, post1, post2; 6 per layer
    # the last layer's dense product feeds no later layer: zero on both sides
    last_dense = 1 + 5 * 6
    assert not port[last_dense].any() and not ref[last_dense].any()
    gaps = [_rel(a, b) for i, (a, b) in enumerate(zip(port, ref)) if i != last_dense]
    assert max(gaps) <= GRAD_TOL, gaps


def test_two_steps_equal_the_reference():
    cfg = _cfg()
    net = WaveNet(cfg)
    optimizer, schedule = make_optimizer(cfg, "wavenet")
    step_fn = build_wavenet_train_step(net, optimizer, cfg, schedule=schedule,
                                       use_lc=True, ema_decay=0.0)
    p0 = _params(cfg)
    state = TrainState(0, p0, {}, optimizer.init(p0), None)
    batches = _batches(cfg, 2, seed=5)
    losses = []
    for b in batches:
        state, metrics = step_fn(state, _port64(cfg, b))
        losses.append(float(metrics["loss"]))
    ref_losses, _, ref_p2 = rtrain.train(cfg.values(), p0, [_ref(b) for b in batches])
    assert np.allclose(losses, ref_losses, rtol=LOSS_TOL, atol=0)
    start = rtrain.leaves(p0)
    moved = [(a - s, b - s) for a, b, s in zip(rtrain.leaves(state.params), ref_p2, start)]
    # the last layer's dense product feeds no later layer: its gradient is
    # zero and it stays on both sides; every other leaf moves
    still = [i for i, (_, b) in enumerate(moved) if not b.any()]
    assert still == [1 + 5 * 6] and not moved[still[0]][0].any()     # its dense
    gaps = [_rel(a, b) for i, (a, b) in enumerate(moved) if i not in still]
    assert max(gaps) <= CHANGE_TOL, gaps


def test_codes_equal_the_ports_encoder_on_the_16_bit_grid():
    x = torch.arange(-32768, 32768, dtype=torch.float32) / 32768.0
    for q in (32, 256):
        assert torch.equal(rtrain.mu_law_codes(x, q), mu_law_encode(x, q).long())


def test_conditioning_equals_the_ports_batch_lc():
    cfg = _cfg()
    (batch,) = _batches(cfg, 1)
    port = batch_lc(wavenet_batch_to_device(batch, torch.device("cpu")), cfg)
    for b in range(cfg.batch_size):
        ref = rtrain.conditioning(cfg.values(), torch.from_numpy(batch.mel[b]),
                                  int(batch.mel_phase[b]), batch.audio.shape[1])
        # one float32 rounding of the blend apart at most
        torch.testing.assert_close(port[b], ref, rtol=2e-7, atol=2e-7)


def test_windows_equal_the_feeders(tmp_path):
    from scipy.io import wavfile

    cfg = _cfg()
    rng = np.random.default_rng(9)
    (tmp_path / "wavs").mkdir()
    lines = []
    for i, n in enumerate((3000, 6000, 12000)):
        t = np.arange(n) / 20000.0
        wav = 0.6 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n)
        wavfile.write(str(tmp_path / "wavs" / f"W{i}.wav"), 20000,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        lines.append(f"W{i}|text {i}|text {i}")
    (tmp_path / "metadata.csv").write_text("\n".join(lines) + "\n")
    c = cfg.values()
    feeder = WaveNetFeeder({"ljspeech": str(tmp_path)}, WaveNet(cfg).receptive_field, cfg)
    got = []
    for item in feeder._items:
        got += [(w, m, p) for w, _, m, p in feeder._utterance_windows(item)]
    want = []
    for i in range(3):
        wav = rtrain.utterance(c, str(tmp_path / "wavs" / f"W{i}.wav"))
        mel = rdsp.featurize(wav, c)[1]
        size = rtrain.receptive_field(c) + c["sample_size"]
        for off in rtrain.window_offsets(c, len(wav)):
            want.append((wav[off:off + size],) + rtrain.window_rows(c, mel, off))
    assert len(got) == len(want) > 3
    for (w, m, p), (rw, rm, rp) in zip(got, want):
        assert np.array_equal(w, rw) and np.array_equal(m, rm) and p == rp


def test_reference_imports_nothing_of_the_port_nor_jax():
    code = ("import sys, benchmark.reference.wavenet_train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'nspeech_tpu_torch', 'nspeech_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(Path(__file__).parents[1]))
    assert out.stdout.strip() == "[]"
