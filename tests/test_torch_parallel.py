"""Data parallelism in the port (``nspeech_tpu_torch/parallel``), on the
CPU at tiny widths, against the port's single-device code and the JAX
package's 8-device mesh.

Multi-rank cases run in worker processes of this file (``python
tests/test_torch_parallel.py WORKDIR RANK WORLD PORT``): a gloo process
group on 127.0.0.1, W = 2 and W = 4, started once for the module (both
worlds at once). The parent prepares the weights (JAX's init, bridged)
and the batches, runs the single-device references and JAX's mesh
counterparts (JAX runs only in the parent) and compares:

- (a) one Tacotron-1 and one Tacotron-2 step with 3 speakers, prenet
  dropout 0.5, scheduled sampling 0.5 and guided attention, a generator
  of one seed on every rank: W ranks on their rows equal the single-device
  step on the global batch of 8, float64 parameters, batch-norm state and
  EMA within 1e-10 of each leaf's largest entry, and the float32 loss
  within 1e-6 relative; every rank leaves with the same state;
- (b) the W = 2 gradients without a generator against JAX's mesh step
  (``build_tacotron_train_step(mesh=make_mesh())``): the whole gradient
  within 1e-4 in relative 2-norm, each leaf within 1e-2 of its largest
  entry, the loss within 1e-5 relative. ``test_torch_train_step.py``'s
  per-leaf 1e-4 holds on its batch of 2 but not on this batch of 8, for
  the port's single-device step against JAX's single-device step either:
  a float32 relu input or L1 residual within rounding of 0 passes or
  stops its gradient in one package only (found on this batch: one
  linear residual of 2.4e-8 of 1.64 M changes sign, moving Tacotron-2's
  ``linear_proj`` kernel by 4.5e-4 of its largest entry single and
  mesh alike; a highway relu, Tacotron-1's encoder highway by 2.4e-2
  single-device; JAX's mesh and single-device steps flip other
  entries). Readings, W = 2 against the mesh: relative 2-norm 3.6e-5 and
  5.8e-6, worst leaf 1.7e-3 and 4.5e-4 (Tacotron-1, Tacotron-2);
- (c) the WaveNet step (gc, frame-rate lc, L2) at W = 2 and 4 against the
  single-device one (float64, 1e-10) and its W = 2 gradients against
  JAX's mesh step (1e-5 of each leaf's largest, as
  ``test_torch_wavenet_train.py``; loss 1e-5 relative);
- (d) training batch norm across the ranks: each rank's rows of the
  output and the running statistics equal the single-device ones
  (float64, 1e-12);
- (e) the feeders' shard k: the same items and batches as JAX's for one
  seed, the speaker map and the holdout global;
- (g) time-sharded WaveNet logits (gc and lc) at W = 2 and 4 against the
  unsharded port on the zero-padded window and against JAX's 8-way
  ``make_time_sharded_logits`` (2e-5 absolute, JAX's own tolerance), the
  time-sharded step against the plain step on the padded window
  (float64, 1e-10) and its loss against JAX's time-sharded step (1e-5
  relative); the halo's backward (each rank's gradient chunk, float64,
  1e-12); the length-sharded postnet and encoder convs against the
  unsharded port and JAX's (1e-6); the bad-length errors.

``test_torch_serving_mesh.py`` holds ``Synthesizer(mesh=...)``.
"""

import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

from nspeech_tpu_torch.config import load_config as t_load  # noqa: E402
from nspeech_tpu_torch.models import create_model  # noqa: E402
from nspeech_tpu_torch.ops import layers as TL  # noqa: E402
from nspeech_tpu_torch.parallel import collectives  # noqa: E402
from nspeech_tpu_torch.parallel.mesh import DataParallel  # noqa: E402
from nspeech_tpu_torch.train import loop as tloop  # noqa: E402
from nspeech_tpu_torch.train.optim import make_optimizer as t_make_optimizer  # noqa: E402
from nspeech_tpu_torch.utils.tree import named_leaves, tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

WORLDS = (2, 4)
ROWS = 8                # the global batch (JAX's mesh has 8 devices)
T_SHARD = 8 * 16        # time-sharded window: 8 chunks of 16 >= rf 9
TACO = {
    "taco2": ("encoder_conv_layers=2,postnet_conv_layers=2,expand_conv_layers=2,"
              "encoder_conv_channels=32,attention_dim=32,postnet_conv_channels=32,"
              "expand_conv_channels=32,decoder_lstm_units=32,"
              "encoder_lstm_units=16,expand_lstm_units=16,embedding_dim=32"),
    "taco1": ("encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
              "decoder_dim=32,embedding_dim=32"),
}
COMMON = f"batch_size={ROWS},batch_group_size=1,num_speakers=3"
GEN = "drop_rate=0.5,scheduled_sampling_ratio=0.5,guided_attention_weight=0.5,ema_decay=0.9"
NO_GEN = "drop_rate=0.0"
WN = ("dilations_length=4,dilations_depth=2,residual_channels=8,"
      "dilation_channels=8,skip_channels=16,quantization_channels=128,"
      "lc_channels=20,gc_channels=4,gc_category_cardinality=3,"
      "l2_regularization_strength=0.01,batch_size=8")
WN_SHARD = ("dilations_length=3,dilations_depth=1,residual_channels=8,"
            "dilation_channels=8,skip_channels=16,quantization_channels=64,"
            "gc_channels=4,gc_category_cardinality=3,lc_channels=5")
HOP = 250


# ---------------------------------------------------------------------------
# The cases, run by the workers (dp: their rank) and by the parent (dp None:
# one device, the global batch)
# ---------------------------------------------------------------------------

def taco_hparams(name, gen):
    return ",".join([TACO[name], COMMON, GEN if gen else NO_GEN])


def to64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


def rows(x, dp):
    return x if dp is None else x[dp.rows(x.shape[0])]


def taco_batch(b, dp, dtype):
    return tloop.TacotronBatch(
        rows(b["inputs"], dp), rows(b["input_lengths"], dp),
        rows(b["speaker_ids"], dp), rows(b["mel_targets"], dp).to(dtype),
        rows(b["linear_targets"], dp).to(dtype))


def taco_step(c, dp, dtype):
    """One step with a generator: (state, metrics)."""
    cfg = t_load(c["name"]).parse(taco_hparams(c["name"], True))
    model = create_model(c["name"], cfg)
    opt, sched = t_make_optimizer(cfg, c["name"])
    params, bn = c["params"], c["bn_state"]
    if dtype == torch.float64:
        params, bn = to64(params), to64(bn)
    state = tloop.TrainState(0, params, bn, opt.init(params),
                             tree_map(torch.clone, params))
    step = tloop.build_tacotron_train_step(model, opt, sched, cfg.ema_decay, dp=dp)
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)      # the decoder's zero carries too
    try:
        return step(state, taco_batch(c["batch"], dp, dtype),
                    torch.Generator().manual_seed(5))
    finally:
        torch.set_default_dtype(saved)


def taco_grads(c, dp):
    """Gradients and metrics without a generator (float32)."""
    cfg = t_load(c["name"]).parse(taco_hparams(c["name"], False))
    model = create_model(c["name"], cfg)
    opt, _ = t_make_optimizer(cfg, c["name"])
    state = tloop.TrainState(0, c["params"], c["bn_state"], opt.init(c["params"]))
    grads, metrics, _ = tloop.tacotron_grads(
        model, state, taco_batch(c["batch"], dp, torch.float32), None, dp=dp)
    return grads, metrics


def wn_batch(b, dp, dtype=torch.float32):
    return tloop.WaveNetDeviceBatch(rows(b["audio"], dp).to(dtype),
                                    rows(b["speaker_ids"], dp),
                                    rows(b["mel"], dp), rows(b["mel_phase"], dp))


def wn_step(c, dp):
    """One float64 WaveNet step (the conditioning upsampled in float32)."""
    cfg = t_load("wavenet").parse(WN + ",ema_decay=0.9")
    net = create_model("wavenet", cfg)
    opt, sched = t_make_optimizer(cfg, "wavenet")
    params = to64(c["params"])
    state = tloop.TrainState(0, params, {}, opt.init(params),
                             tree_map(torch.clone, params))
    step = tloop.build_wavenet_train_step(net, opt, cfg, sched, True, True,
                                          0.01, cfg.ema_decay, dp=dp)
    b = wn_batch(c["batch"], dp)
    from nspeech_tpu_torch.ops.upsample import batch_lc

    lc = batch_lc(b, cfg).double()
    return step(state, b._replace(audio=b.audio.double(), mel=lc,
                                  mel_phase=None))


def wn_grads(c, dp):
    cfg = t_load("wavenet").parse(WN)
    net = create_model("wavenet", cfg)
    return tloop.wavenet_grads(net, c["params"], wn_batch(c["batch"], dp),
                               cfg, True, True, 0.01, dp=dp)


def bn_case(c, dp):
    with collectives.data_parallel(dp):
        return TL.batch_norm(c["params"], c["state"], rows(c["x"], dp), True)


def shard_net():
    return create_model("wavenet", t_load("wavenet").parse(WN_SHARD))


def shard_step_state(c):
    cfg = t_load("wavenet").parse(WN_SHARD)
    opt, sched = t_make_optimizer(cfg, "wavenet")
    params = to64(c["params"])
    return cfg, opt, sched, tloop.TrainState(0, params, {}, opt.init(params))


HALO = 5


def halo_weights(world, width):
    """Per-rank weights [world, 2, width, 3] of the halo-gradient case."""
    return torch.randn((world, 2, width, 3), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(world))


def halo_case(x, dp):
    """d/dx of sum(window * w) over this rank's window [left halo | chunk]:
    the rank's chunk of the gradient, the part that reached the left
    neighbour's halo sent back to it."""
    from nspeech_tpu_torch.parallel.timeshard import left_halo

    t = x.shape[1] // dp.world
    loc = x[:, dp.rank * t:(dp.rank + 1) * t].clone().requires_grad_(True)
    window = torch.cat([left_halo(loc, HALO, dp), loc], dim=1)
    (window * halo_weights(dp.world, t + HALO)[dp.rank]).sum().backward()
    return loc.grad


def worker(workdir, rank, world, port):
    from nspeech_tpu_torch.parallel.lengthshard import (
        make_length_sharded_encoder_convs, make_length_sharded_postnet)
    from nspeech_tpu_torch.parallel.mesh import initialize_multihost
    from nspeech_tpu_torch.parallel.timeshard import (
        build_time_sharded_wavenet_step, make_time_sharded_logits)

    # JAX's signature over init_distributed (gloo, on the CPU)
    dp = initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    assert (dp.rank, dp.world) == (rank, world)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)

    def lead(tree):
        """(the tree on rank 0, else None; its largest distance from rank
        0's): the trees a step leaves are the same on every rank, so only
        rank 0 writes them."""
        worst = 0.0
        for leaf in tree_leaves(tree):
            ref = leaf.clone()
            torch.distributed.broadcast(ref, 0)
            worst = max(worst, (leaf - ref).abs().max().item())
        return (tree if rank == 0 else None), worst

    out = {}
    for name in ("taco1", "taco2"):
        c = cases[name]
        state, m = taco_step(c, dp, torch.float64)
        out[name + "/gen64"] = (lead((state.params, state.bn_state,
                                      state.ema_params)), m)
        out[name + "/gen32"] = taco_step(c, dp, torch.float32)[1]
        if world == 2:
            grads, m = taco_grads(c, dp)
            out[name + "/grads"] = (lead(grads), m)
    out["wavenet/step"] = wn_step(cases["wavenet"], dp)
    if world == 2:
        grads, m = wn_grads(cases["wavenet"], dp)
        out["wavenet/grads"] = (lead(grads), m)
    out["bn"] = bn_case(cases["bn"], dp)
    c = cases["timeshard"]
    net = shard_net()
    out["timeshard/logits"] = make_time_sharded_logits(net, dp, True, True)(
        c["params"], c["audio"], c["gc"], c["lc"])
    cfg, opt, sched, state = shard_step_state(c)
    step = build_time_sharded_wavenet_step(net, opt, dp, True, True, sched, cfg)
    out["timeshard/step"] = step(state, tloop.WaveNetDeviceBatch(
        c["audio"].double(), c["gc"], c["lc"].double(), None))
    c = cases["lengthshard"]
    out["lengthshard/postnet"] = make_length_sharded_postnet(dp)(
        c["postnet"], c["postnet_state"], c["x_post"])
    out["lengthshard/encoder"] = make_length_sharded_encoder_convs(dp)(
        c["encoder"], c["encoder_state"], c["x_enc"])
    out["halo"] = halo_case(cases["halo"], dp)
    torch.save(out, os.path.join(workdir, f"out-{world}-{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    sys.exit(0)


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nspeech_tpu.config import load_config as j_load  # noqa: E402
from nspeech_tpu.data.feeder import DataFeeder as JFeeder  # noqa: E402
from nspeech_tpu.data.wavenet_feeder import WaveNetBatch as JWBatch  # noqa: E402
from nspeech_tpu.data.wavenet_feeder import WaveNetFeeder as JWFeeder  # noqa: E402
from nspeech_tpu.models import create_model as j_create  # noqa: E402
from nspeech_tpu.models.modules import init_conv_and_lstm, init_postnet  # noqa: E402
from nspeech_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from nspeech_tpu.parallel import shard_batch as j_shard_batch  # noqa: E402
from nspeech_tpu.train import loop as jloop  # noqa: E402
from nspeech_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from nspeech_tpu_torch import convert  # noqa: E402
from nspeech_tpu_torch.data.feeder import DataFeeder as TFeeder  # noqa: E402
from nspeech_tpu_torch.data.wavenet_feeder import WaveNetFeeder as TWFeeder  # noqa: E402

from tests.make_synth_corpus import make_corpus  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")), n=8)


class Runs:
    """The cases, and the workers of both worlds (started at once)."""

    def __init__(self, corpus):
        self.dir = tempfile.mkdtemp(prefix="torch_parallel_")
        self.cases, self.jax = make_cases(corpus)
        torch.save(self.cases, os.path.join(self.dir, "cases.pt"))
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        self.procs = {}
        for world in WORLDS:
            port = _free_port()
            self.procs[world] = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), self.dir, str(r),
                 str(world), str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO) for r in range(world)]
        self.outs = {}
        self._memo = {}

    def memo(self, key, fn):
        """``fn()``, once per key: the references both worlds are held to."""
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def get(self, world):
        """The outputs of each rank of ``world`` (waits for them)."""
        if world not in self.outs:
            logs = [p.communicate(timeout=300)[0] for p in self.procs[world]]
            for r, (p, log) in enumerate(zip(self.procs[world], logs)):
                assert p.returncode == 0, f"rank {r} of {world}:\n{log[-3000:]}"
            self.outs[world] = [torch.load(
                os.path.join(self.dir, f"out-{world}-{r}.pt"), weights_only=False)
                for r in range(world)]
        return self.outs[world]


def make_cases(corpus):
    """The inputs (torch) of every case, and the JAX models, weights and
    batches they were bridged from."""
    rng = np.random.default_rng(0)
    cases, jx = {}, {}
    jc = j_load("taco2").parse(",".join([TACO["taco2"], COMMON]))
    b = next(JFeeder({"ljspeech": corpus}, jc, seed=0).epoch_batches(0))
    b = b._replace(speaker_ids=rng.integers(0, 3, ROWS).astype(np.int32))
    for name in ("taco1", "taco2"):
        jcfg = j_load(name).parse(taco_hparams(name, False))
        jm = j_create(name, jcfg)
        jp, js = jm.init(jax.random.PRNGKey(0))
        tcfg = t_load(name).parse(taco_hparams(name, False))
        tp, ts = convert.tacotron_variables(create_model(name, tcfg),
                                            np_tree(jp), np_tree(js))
        cases[name] = {"name": name, "params": tp, "bn_state": ts, "batch": {
            "inputs": torch.from_numpy(b.inputs).long(),
            "input_lengths": torch.from_numpy(b.input_lengths).long(),
            "speaker_ids": torch.from_numpy(b.speaker_ids).long(),
            "mel_targets": torch.from_numpy(b.mel_targets),
            "linear_targets": torch.from_numpy(b.linear_targets)}}
        jx[name] = (jcfg, jm, jp, js, b)

    jwc = j_load("wavenet").parse(WN)
    jn = j_create("wavenet", jwc)
    jwp = jn.init(jax.random.PRNGKey(0))
    window = jn.receptive_field + 64
    frames = (window + HOP - 2) // HOP + 2
    wb = JWBatch(rng.uniform(-0.9, 0.9, (ROWS, window)).astype(np.float32),
                 rng.integers(0, 3, ROWS).astype(np.int32),
                 rng.random((ROWS, frames, 20), dtype=np.float32),
                 rng.integers(0, HOP, ROWS).astype(np.int32))
    cases["wavenet"] = {
        "params": convert.wavenet_params(create_model("wavenet", t_load("wavenet").parse(WN)),
                                         np_tree(jwp)),
        "batch": {"audio": torch.from_numpy(wb.audio),
                  "speaker_ids": torch.from_numpy(wb.speaker_ids).long(),
                  "mel": torch.from_numpy(wb.mel),
                  "mel_phase": torch.from_numpy(wb.mel_phase).long()}}
    jx["wavenet"] = (jwc, jn, jwp, wb)

    x = rng.standard_normal((ROWS, 10, 6)) * 2.0 + 0.5
    x[1, 6:] = 0.0              # padded frames take part in the moments
    cases["bn"] = {"x": torch.from_numpy(x),
                   "params": {"scale": torch.from_numpy(rng.uniform(0.5, 1.5, 6)),
                              "offset": torch.from_numpy(rng.standard_normal(6))},
                   "state": {"mean": torch.from_numpy(rng.standard_normal(6)),
                             "var": torch.from_numpy(rng.uniform(0.5, 2.0, 6))}}

    jsc = j_load("wavenet").parse(WN_SHARD)
    jsn = j_create("wavenet", jsc)
    jsp = jsn.init(jax.random.PRNGKey(0))
    audio = rng.uniform(-0.5, 0.5, (2, T_SHARD)).astype(np.float32)
    gc = np.array([0, 2], np.int32)
    lc = rng.random((2, T_SHARD, 5), dtype=np.float32)
    cases["timeshard"] = {"params": convert.wavenet_params(shard_net(), np_tree(jsp)),
                          "audio": torch.from_numpy(audio),
                          "gc": torch.from_numpy(gc).long(),
                          "lc": torch.from_numpy(lc)}
    jx["timeshard"] = (jsc, jsn, jsp, audio, gc, lc)

    pp, ps = init_postnet(jax.random.PRNGKey(0), in_dim=80, conv_layers=5,
                          conv_width=5, channels=32)
    # running statistics away from (0, 1), so that inference uses them
    ps = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.arange(a.size).reshape(a.shape), ps)
    ep, es, _ = init_conv_and_lstm(jax.random.PRNGKey(1), in_dim=16,
                                   conv_layers=3, conv_width=5,
                                   conv_channels=16, lstm_units=8)
    x_post = rng.random((2, 128, 80), dtype=np.float32)
    x_enc = rng.random((2, 96, 16), dtype=np.float32)
    cases["lengthshard"] = {
        "postnet": t_tree(pp), "postnet_state": t_tree(ps),
        "encoder": t_tree({"convs": ep["convs"]}),
        "encoder_state": t_tree(es), "x_post": torch.from_numpy(x_post),
        "x_enc": torch.from_numpy(x_enc)}
    jx["lengthshard"] = (pp, ps, ep, es, x_post, x_enc)
    cases["halo"] = torch.from_numpy(rng.standard_normal((2, 64, 3)))
    return cases, jx


@pytest.fixture(scope="module")
def runs(corpus):
    r = Runs(corpus)
    try:
        yield r
    finally:
        for procs in r.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        shutil.rmtree(r.dir, ignore_errors=True)


def leaf_gap(ref, got):
    """The worst leaf of |got - ref| over the leaf's largest |ref|. A conv
    bias that feeds batch norm with no activation between has a gradient
    that cancels to rounding noise (exactly 0 in exact arithmetic), which
    Adam's first step scales up to the size of the bias itself: it is
    measured against its conv kernel, as ``chip_smoke.py``'s
    ``leaf_gaps``."""
    ref, got = dict(named_leaves(ref)), dict(named_leaves(got))
    worst = 0.0
    for path, r in ref.items():
        base = ref[path[:-4] + "kernel"] if path.endswith("/conv/bias") else r
        err = (got[path].double() - r.double()).abs().max().item()
        worst = max(worst, err / max(base.double().abs().max().item(), 1e-300))
    return worst


def close_rel(a, b, rtol):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_mesh_construction_and_batch_sharding():
    from nspeech_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                            replicate, replicated, shard_batch)

    assert initialize_multihost(num_processes=1) is None   # one process: nothing

    mesh = make_mesh(["cpu"] * 8)
    assert mesh.devices.shape == (8, 1) and mesh.axis_names == ("data", "model")
    mesh42 = make_mesh(["cpu"] * 8, model_parallel=2)
    assert mesh42.shape == {"data": 4, "model": 2}
    assert len(replicated(mesh42)) == 4
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        make_mesh(["cpu"] * 6, model_parallel=4)
    b = tloop.TacotronBatch(*(torch.arange(8 * k).reshape(8, k) for k in (1, 2, 3, 4, 5)))
    shards = shard_batch(b, mesh42)
    assert len(shards) == 4 and all(s.inputs.shape == (2, 1) for s in shards)
    torch.testing.assert_close(torch.cat([s.mel_targets for s in shards]), b.mel_targets)
    mine = shard_batch(b, DataParallel(1, 4, torch.device("cpu")))
    torch.testing.assert_close(mine.linear_targets, b.linear_targets[2:4])
    tree = {"w": torch.ones(3)}
    assert len(replicate(tree, mesh42)) == 4
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(b, DataParallel(0, 3, torch.device("cpu")))


@pytest.mark.parametrize("name,world", [(n, w) for n in ("taco1", "taco2")
                                        for w in WORLDS])
def test_tacotron_step_matches_single_device(runs, name, world):
    """(a): the W-rank step with a generator is the single-device step on
    the global batch."""
    ref_state, ref_m = runs.memo(name + "/gen64", lambda: taco_step(
        runs.cases[name], None, torch.float64))
    ref32 = runs.memo(name + "/gen32", lambda: taco_step(
        runs.cases[name], None, torch.float32)[1])
    outs = runs.get(world)
    (trees, _), _ = outs[0][name + "/gen64"]
    for field, tree in zip(("params", "bn_state", "ema_params"), trees):
        gap = leaf_gap(getattr(ref_state, field), tree)
        assert gap <= 1e-10, (field, gap)
    for r, out in enumerate(outs):
        (_, worst), m = out[name + "/gen64"]
        assert worst == 0.0, r     # every rank leaves with rank 0's state
        close_rel(m["loss"], ref_m["loss"], 1e-10)
        assert "loss_guided_attention" in m
        close_rel(m["loss_guided_attention"], ref_m["loss_guided_attention"], 1e-10)
        close_rel(m["grad_norm"], ref_m["grad_norm"], 1e-10)
        m32 = out[name + "/gen32"]
        for k, v in ref32.items():
            if isinstance(v, torch.Tensor) and v.ndim == 0:
                close_rel(m32[k], v, 1e-6)


def capture(tx):
    """An optax stage in front of ``tx`` that keeps the gradients it is
    given in its state (as ``test_torch_train_step.py``)."""
    def init(params):
        return ({"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
                tx.init(params))

    def update(g, state, params=None):
        u, s = tx.update(g, state[1], params)
        return u, ({"g": g}, s)

    return optax.GradientTransformation(init, update)


def check_jax_grads(jgrads, tgrads, leaf_tol, norm_tol=None):
    """Each leaf of the port's gradient within ``leaf_tol`` of the leaf's
    largest entry in JAX's (a conv bias that feeds batch norm: of its
    kernel's, see :func:`leaf_gap`) and, with ``norm_tol``, the whole
    gradient within it in relative 2-norm."""
    jl = jax.tree_util.tree_leaves_with_path(jgrads)
    tl = named_leaves(tgrads)
    assert len(jl) == len(tl)
    ref = {p: torch.from_numpy(np.array(j)) for (_, j), (p, _) in zip(jl, tl)}
    assert leaf_gap(ref, dict(tl)) <= leaf_tol
    if norm_tol is not None:
        err = sum(torch.sum((t.double() - ref[p].double()) ** 2) for p, t in tl)
        norm = sum(torch.sum(r.double() ** 2) for r in ref.values())
        assert (err / norm).sqrt() <= norm_tol, float((err / norm).sqrt())


@pytest.mark.parametrize("name", ["taco1", "taco2"])
def test_tacotron_grads_match_jax_mesh_step(runs, name):
    """(b): W = 2 without a generator against JAX's 8-way mesh step."""
    jcfg, jm, jp, js, b = runs.jax[name]
    jtx, jsched = j_make_optimizer(jcfg, name)
    mesh = j_make_mesh()
    jstep = jloop.build_tacotron_train_step(jm, capture(jtx), mesh=mesh,
                                            schedule=jsched)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), jp, js,
                              capture(jtx).init(jp))
    jstate, jmet = jstep(jstate, j_shard_batch(b, mesh), jax.random.PRNGKey(1))
    outs = runs.get(2)
    check_jax_grads(jstate.opt_state[0]["g"], outs[0][name + "/grads"][0][0],
                    1e-2, 1e-4)
    for out in outs:
        (_, worst), metrics = out[name + "/grads"]
        assert worst == 0.0
        close_rel(metrics["loss"], jmet["loss"], 1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_wavenet_step_matches_single_device(runs, world):
    """(c): the WaveNet step over the ranks' windows."""
    ref_state, ref_m = runs.memo("wavenet/step", lambda: wn_step(
        runs.cases["wavenet"], None))
    for out in runs.get(world):
        state, m = out["wavenet/step"]
        for field in ("params", "ema_params"):
            gap = leaf_gap(getattr(ref_state, field), getattr(state, field))
            assert gap <= 1e-10, (field, gap)
        for k in ("loss", "l2_loss", "total_loss", "grad_norm"):
            close_rel(m[k], ref_m[k], 1e-10)


def test_wavenet_grads_match_jax_mesh_step(runs):
    jc, jn, jp, wb = runs.jax["wavenet"]
    jtx, _ = j_make_optimizer(jc, "wavenet")
    mesh = j_make_mesh()
    jstep = jloop.build_wavenet_train_step(jn, capture(jtx), jc, mesh=mesh,
                                           use_gc=True, use_lc=True,
                                           l2_strength=0.01)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), jp, {},
                              capture(jtx).init(jp))
    jstate, jmet = jstep(jstate, j_shard_batch(wb, mesh), None)
    outs = runs.get(2)
    check_jax_grads(jstate.opt_state[0]["g"], outs[0]["wavenet/grads"][0][0], 1e-5)
    for out in outs:
        (_, worst), metrics = out["wavenet/grads"]
        assert worst == 0.0
        close_rel(metrics["loss"], jmet["loss"], 1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_norm_across_ranks(runs, world):
    """(d): each rank's rows of the output, and the running statistics, are
    the single-device ones."""
    ref_y, ref_s = bn_case(runs.cases["bn"], None)
    outs = runs.get(world)
    y = torch.cat([out["bn"][0] for out in outs])
    torch.testing.assert_close(y, ref_y, rtol=0, atol=1e-12)
    for out in outs:
        for k in ("mean", "var"):
            torch.testing.assert_close(out["bn"][1][k], ref_s[k], rtol=0, atol=1e-12)


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_feeder_shards_match_jax(corpus, shard):
    """(e): shard k of 3 has JAX's items and batches; the speaker map and
    the holdout are global."""
    jc = j_load("taco2").parse("batch_size=2,batch_group_size=2")
    tc = t_load("taco2").parse("batch_size=2,batch_group_size=2")
    kw = dict(seed=3, holdout=1, shard_index=shard, shard_count=3)
    jf = JFeeder({"ljspeech": corpus}, jc, **kw)
    tf = TFeeder({"ljspeech": corpus}, tc, **kw)
    assert tf._items == jf._items and len(tf._items) in (2, 3)
    assert tf.holdout_items == jf.holdout_items
    assert tf.speaker2id == jf.speaker2id
    full = TFeeder({"ljspeech": corpus}, tc, seed=3, holdout=1)
    assert tf._items == full._items[shard::3]
    jbs, tbs = list(jf.epoch_batches(1)), list(tf.epoch_batches(1))
    assert len(jbs) == len(tbs) > 0
    for jb, tb in zip(jbs, tbs):
        for k in ("inputs", "input_lengths", "speaker_ids", "audio"):
            np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k))
        # the featurizers' own agreement (test_torch_train_data.py)
        np.testing.assert_allclose(tb.linear_targets, jb.linear_targets,
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(tb.mel_targets, jb.mel_targets,
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("shard", [0, 1])
def test_wavenet_feeder_shards_match_jax(corpus, shard):
    cfg = "sample_size=512,batch_size=2"
    jf = JWFeeder({"ljspeech": corpus}, 256, j_load("wavenet").parse(cfg),
                  seed=2, shard_index=shard, shard_count=2)
    tf = TWFeeder({"ljspeech": corpus}, 256, t_load("wavenet").parse(cfg),
                  seed=2, shard_index=shard, shard_count=2)
    assert tf._items == jf._items and len(tf._items) == 4
    assert tf.speaker2id == jf.speaker2id
    jb, tb = next(jf.batches()), next(tf.batches())
    np.testing.assert_array_equal(tb.speaker_ids, jb.speaker_ids)
    np.testing.assert_allclose(tb.audio, jb.audio, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tb.mel_phase, jb.mel_phase)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_logits(runs, world):
    """(g): the ranks' chunks are the unsharded logits on the zero-padded
    window, and JAX's 8-way time-sharded logits."""
    from nspeech_tpu.parallel.timeshard import make_time_sharded_logits as j_ts

    c = runs.cases["timeshard"]
    net = shard_net()
    rf = net.receptive_field
    ref, ref_t = net.forward_train(
        c["params"], torch.nn.functional.pad(c["audio"], (rf, 0)),
        gc_ids=c["gc"], lc=torch.nn.functional.pad(c["lc"], (0, 0, rf, 0)))

    def jax_logits():
        jsc, jsn, jsp, audio, gc, lc = runs.jax["timeshard"]
        return np.asarray(j_ts(jsn, j_make_mesh(), use_gc=True, use_lc=True)(
            jsp, jnp.asarray(audio), gc_ids=jnp.asarray(gc),
            lc=jnp.asarray(lc))[0])

    outs = runs.get(world)
    logits = torch.cat([out["timeshard/logits"][0] for out in outs], dim=1)
    targets = torch.cat([out["timeshard/logits"][1] for out in outs], dim=1)
    assert logits.shape == (2, T_SHARD, 64)
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(targets, ref_t, rtol=0, atol=0)
    np.testing.assert_allclose(logits.numpy(), runs.memo("timeshard/jax", jax_logits),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_step(runs, world):
    """(g): the time-sharded step is the plain step on the zero-padded
    window (float64), and its loss JAX's time-sharded step's."""
    c = runs.cases["timeshard"]
    net = shard_net()
    rf = net.receptive_field
    cfg, opt, sched, state = shard_step_state(c)
    step = tloop.build_wavenet_train_step(net, opt, cfg, sched, True, True)
    ref_state, ref_m = runs.memo("timeshard/step", lambda: step(
        state, tloop.WaveNetDeviceBatch(
            torch.nn.functional.pad(c["audio"].double(), (rf, 0)), c["gc"],
            torch.nn.functional.pad(c["lc"].double(), (0, 0, rf, 0)), None)))
    for out in runs.get(world):
        st, m = out["timeshard/step"]
        assert leaf_gap(ref_state.params, st.params) <= 1e-10
        close_rel(m["loss"], ref_m["loss"], 1e-10)
        close_rel(m["grad_norm"], ref_m["grad_norm"], 1e-10)
        assert m["learning_rate"] == ref_m["learning_rate"]
    if world != 2:
        return
    from nspeech_tpu.parallel.timeshard import build_time_sharded_wavenet_step as j_step
    from nspeech_tpu.train import create_state

    jsc, jsn, jsp, audio, gc, lc = runs.jax["timeshard"]
    jtx, jsched = j_make_optimizer(jsc, "wavenet")
    jstate = create_state(jsn, jtx, jax.random.PRNGKey(0))    # params: jsp
    _, jm = j_step(jsn, jtx, j_make_mesh(), use_gc=True, use_lc=True,
                   schedule=jsched, cfg=jsc)(
        jstate, JWBatch(jnp.asarray(audio), jnp.asarray(gc), jnp.asarray(lc)), None)
    close_rel(runs.get(2)[0]["timeshard/step"][1]["loss"], jm["loss"], 1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_left_halo_gradient_returns_to_its_neighbour(runs, world):
    """The halo's backward: the ranks' gradient chunks are autograd's
    through the same windows cut from the global tensor in one process."""
    x = runs.cases["halo"].clone().requires_grad_(True)
    t = x.shape[1] // world
    w = halo_weights(world, t + HALO)
    total = 0.0
    for r in range(world):
        loc = x[:, r * t:(r + 1) * t]
        halo = x[:, r * t - HALO:r * t] if r else torch.zeros_like(loc[:, :HALO])
        total = total + (torch.cat([halo, loc], dim=1) * w[r]).sum()
    total.backward()
    got = torch.cat([out["halo"] for out in runs.get(world)], dim=1)
    torch.testing.assert_close(got, x.grad, rtol=0, atol=1e-12)


@pytest.mark.parametrize("stack,world", [(s, w) for s in ("postnet", "encoder")
                                         for w in WORLDS])
def test_length_sharded_stacks(runs, stack, world):
    """(g): the ranks' chunks are the unsharded stack and JAX's 8-way
    length-sharded stack."""
    from nspeech_tpu.parallel.lengthshard import (
        make_length_sharded_encoder_convs as j_enc,
        make_length_sharded_postnet as j_post)
    from nspeech_tpu_torch.models import modules as TM

    c = runs.cases["lengthshard"]
    pp, ps, ep, es, x_post, x_enc = runs.jax["lengthshard"]
    got = torch.cat([out["lengthshard/" + stack] for out in runs.get(world)], dim=1)
    if stack == "postnet":
        ref = TM.postnet(c["postnet"], c["postnet_state"], c["x_post"])
        jout = runs.memo("postnet/jax", lambda: np.asarray(
            j_post(j_make_mesh())(pp, ps, jnp.asarray(x_post))))
    else:
        y = c["x_enc"]
        n = len(c["encoder"]["convs"])
        for i, (p, s) in enumerate(zip(c["encoder"]["convs"], c["encoder_state"]["convs"])):
            y = TL.conv_bn(p, s, y, torch.relu if i < n - 1 else None)
        ref = y
        jout = runs.memo("encoder/jax", lambda: np.asarray(
            j_enc(j_make_mesh())(ep, es, jnp.asarray(x_enc))))
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), jout, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("what,match", [
    ("time_length", "not divisible by 4 shards"),
    ("time_chunk", "< receptive field"),
    ("length", "not divisible by 4 shards"),
    ("length_chunk", "< kernel halo")])
def test_sharded_forms_reject_bad_lengths(what, match):
    """JAX's checks and messages; they raise before any exchange, so one
    process stands for rank 0 of 4."""
    from nspeech_tpu_torch.models.modules import init_postnet as t_init_postnet
    from nspeech_tpu_torch.parallel.lengthshard import make_length_sharded_postnet
    from nspeech_tpu_torch.parallel.timeshard import make_time_sharded_logits

    dp = DataParallel(0, 4, torch.device("cpu"))
    if what.startswith("time"):
        net = shard_net()
        fn = make_time_sharded_logits(net, dp)
        T = 4 * 16 + 2 if what == "time_length" else 4 * 4     # chunk 4 < rf 9
        with pytest.raises(ValueError, match=match):
            fn(net.init(0), torch.zeros(1, T))
    else:
        p, s = t_init_postnet(np.random.default_rng(0), 8, 2, 5, 8)
        fn = make_length_sharded_postnet(dp)
        T = 30 if what == "length" else 4
        with pytest.raises(ValueError, match=match):
            fn(p, s, torch.zeros(1, T, 8))


def test_indivisible_batch_exits(monkeypatch):
    """A batch that does not divide across the ranks exits before any
    process group forms (the JAX trainer falls back to one device)."""
    from nspeech_tpu_torch.train.runner import pick_mesh

    monkeypatch.delenv("RANK", raising=False)
    assert pick_mesh(6, "cpu") is None
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="multiple of 4"):
        pick_mesh(6, "cpu")
