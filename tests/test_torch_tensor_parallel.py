"""Tensor parallelism in the port (``nspeech_tpu_torch/parallel/tensor.py``
and the model-axis collectives), on the CPU at JAX's tiny widths
(``tests/test_tensor_parallel.py``), against the port's single-device
step and JAX's (data 4 x model 2) mesh.

Multi-rank cases run in worker processes of this file (``python
tests/test_torch_tensor_parallel.py WORKDIR RANK WORLD PORT``): a gloo
process group on 127.0.0.1 laid out as a (data D x model 2) grid, D = 1
and D = 2, started once for the module (both grids at once). The parent
prepares the weights (JAX's init, bridged) and the batch, runs the
single-device references and JAX's mesh step (JAX runs only in the
parent) and compares:

- (a) the rules: ``spec_for_path`` gives JAX's spec for every leaf of
  JAX's full-width Tacotron-2 and Tacotron-1 trees, by path; the port's
  Tacotron-1 (``tp_rules`` empty) shards no leaf;
- (b) ``shard_params`` -> ``merge_params`` is exact at M = 2 and 4, and
  ``gather_params`` over the workers' model group at M = 2; each rank
  holds its units of every LSTM gate; an indivisible width raises;
- (c) one Tacotron-2 step with 3 speakers, prenet dropout 0.5, scheduled
  sampling 0.5 and guided attention, a generator of one seed on every
  rank, at (D, M) = (1, 2) and (2, 2), deferred weight gradients on and
  off: the gathered float64 params, Adam moments, batch-norm state and
  EMA within 1e-10 of each leaf's largest entry of the single-device
  step's on the global batch of 4, the float32 loss within 1e-6
  relative (a conv bias that feeds batch norm, whose gradient is rounding
  noise, is held absolutely after the step: see ``leaf_gap``); every
  rank leaves with the same gathered state, so the replicated leaves are
  equal on every model rank, and with its generator where the
  single-device step leaves it (the same draws on every model rank);
- (d) the (1, 2) gradients without a generator against JAX's
  ``shard_train_state`` step on its 4 x 2 CPU mesh: the loss within 2e-5
  relative (JAX's own test), the whole gradient within 1e-4 in relative
  2-norm and each leaf within 1e-2 of its largest entry (the bounds of
  ``test_torch_parallel.py``, which says why a float32 leaf can move by
  more than 1e-4); the replicated leaves' gradients are equal on both
  model ranks;
- (e) the backwards of ``copy_to_model``, ``reduce_from_model`` and
  ``gather_from_model`` in float64;
- Tacotron-1 under a model axis runs replicated and equals its plain
  step; a bf16 tensor-parallel step is finite and near the plain bf16
  step.
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
from nspeech_tpu_torch.parallel import collectives  # noqa: E402
from nspeech_tpu_torch.parallel.mesh import TensorParallel  # noqa: E402
from nspeech_tpu_torch.parallel.tensor import (  # noqa: E402
    gather_params, gather_train_state, merge_params, shard_params,
    shard_train_state, sharded_leaves, spec_for_path)
from nspeech_tpu_torch.train import loop as tloop  # noqa: E402
from nspeech_tpu_torch.train.optim import make_optimizer as t_make_optimizer  # noqa: E402
from nspeech_tpu_torch.utils.tree import (  # noqa: E402
    keystr, leaves_with_path, named_leaves, tree_leaves, tree_map)

torch.set_num_threads(1)

M = 2                   # model ranks
DATA = (1, 2)           # data ranks of the two grids
ROWS = 4                # the global batch (JAX's test)
TINY = ("max_iters=3,encoder_conv_layers=1,postnet_conv_layers=1,"
        "expand_conv_layers=1,encoder_conv_channels=16,attention_dim=16,"
        "postnet_conv_channels=16,expand_conv_channels=16,"
        "decoder_lstm_units=32,encoder_lstm_units=8,expand_lstm_units=8,"
        f"embedding_dim=16,batch_size={ROWS},num_speakers=3")
TACO1 = (f"encoder_cbhg_banks=2,post_cbhg_banks=2,attention_dim=32,"
         f"decoder_dim=32,embedding_dim=32,batch_size={ROWS},num_speakers=3")
GEN = ("drop_rate=0.5,scheduled_sampling_ratio=0.5,guided_attention_weight=0.5,"
       "ema_decay=0.9")
NO_GEN = "drop_rate=0.0"
BF16_TOL = 1e-2         # bf16 loss, tensor-parallel vs plain: a few bf16 epsilons


# ---------------------------------------------------------------------------
# The cases, run by the workers (dp, tp: their ranks) and by the parent
# (None: one device, the global batch)
# ---------------------------------------------------------------------------

def to64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, tree)


def rows(x, dp):
    return x if dp is None else x[dp.rows(x.shape[0])]


def model_of(name, extra):
    cfg = t_load(name).parse(",".join([TINY if name == "taco2" else TACO1, extra]))
    return cfg, create_model(name, cfg)


def batch_of(b, dp, dtype):
    return tloop.TacotronBatch(
        rows(b["inputs"], dp), rows(b["input_lengths"], dp),
        rows(b["speaker_ids"], dp), rows(b["mel_targets"], dp).to(dtype),
        rows(b["linear_targets"], dp).to(dtype))


def step_case(c, dp, tp, dtype, deferred=None, name="taco2", extra="",
              generator=None):
    """One step with a generator (by default one of seed 5): (state,
    metrics), the state whole (its slices gathered)."""
    cfg, model = model_of(name, ",".join(filter(None, [GEN, extra])))
    opt, sched = t_make_optimizer(cfg, name)
    params, bn = c[name]["params"], c[name]["bn_state"]
    if dtype == torch.float64:
        params, bn = to64(params), to64(bn)
    state = tloop.TrainState(0, params, bn, opt.init(params),
                             tree_map(torch.clone, params))
    if tp is not None:
        state = shard_train_state(state, tp, model.tp_rules)
    step = tloop.build_tacotron_train_step(model, opt, sched, cfg.ema_decay,
                                           deferred_dw=deferred, dp=dp, tp=tp)
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)      # the decoder's zero carries too
    try:
        new, m = step(state, batch_of(c["batch"], dp, dtype),
                      generator or torch.Generator().manual_seed(5))
    finally:
        torch.set_default_dtype(saved)
    if tp is not None:
        new = gather_train_state(new, tp, model.tp_rules)
    return new, m


def grads_case(c, dp, tp):
    """Float32 gradients and metrics without a generator: (local, whole,
    metrics)."""
    cfg, model = model_of("taco2", NO_GEN)
    opt, _ = t_make_optimizer(cfg, "taco2")
    state = tloop.TrainState(0, c["taco2"]["params"], c["taco2"]["bn_state"],
                             opt.init(c["taco2"]["params"]))
    if tp is not None:
        state = shard_train_state(state, tp)
    grads, metrics, _ = tloop.tacotron_grads(
        model, state, batch_of(c["batch"], dp, torch.float32), None, dp=dp, tp=tp)
    return grads, (grads if tp is None else gather_params(grads, tp)), metrics


def op_inputs(world):
    """Per-rank float64 inputs of the operator case: x [world, 3, 4] and
    weights w [world, 3, 4], and replicated weights W [3, 4 * world]."""
    g = torch.Generator().manual_seed(world)
    return (torch.randn((world, 3, 4), dtype=torch.float64, generator=g),
            torch.randn((world, 3, 4), dtype=torch.float64, generator=g),
            torch.randn((3, 4 * world), dtype=torch.float64, generator=g))


def op_case(tp):
    """d/dx of each operator's loss on this rank: ``copy`` the partial
    loss sum(copy(x0) * w[rank]) of a replicated x0, ``reduce``
    sum(reduce(x[rank]) * W[:, :4]), ``gather`` sum(gather(x[rank]) *
    W)."""
    x, w, W = op_inputs(tp.world)
    out = {}
    for name in ("copy", "reduce", "gather"):
        xr = (x[0] if name == "copy" else x[tp.rank]).clone().requires_grad_(True)
        if name == "copy":
            loss = (collectives.copy_to_model(xr, tp) * w[tp.rank]).sum()
        elif name == "reduce":
            loss = (collectives.reduce_from_model(xr, tp) * W[:, :4]).sum()
        else:
            loss = (collectives.gather_from_model(xr, tp) * W).sum()
        loss.backward()
        out[name] = xr.grad
    return out


def worker(workdir, rank, world, port):
    import torch.distributed as dist

    from nspeech_tpu_torch.parallel.mesh import init_distributed

    dp, tp = init_distributed("cpu", rank, world, f"tcp://127.0.0.1:{port}",
                              model_parallel=M)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)

    def lead(tree):
        """(the tree on rank 0, else None; its largest distance from rank
        0's)."""
        worst = 0.0
        for leaf in tree_leaves(tree):
            ref = leaf.clone()
            dist.broadcast(ref, 0)
            worst = max(worst, (leaf - ref).abs().max().item())
        return (tree if rank == 0 else None), worst

    out = {"grid": (dp.rank, dp.world, tp.rank, tp.world)}
    whole = cases["taco2"]["params"]
    out["gathered_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(gather_params(shard_params(whole, tp), tp)),
            tree_leaves(whole)))
    for deferred in (True, False):
        gen = torch.Generator().manual_seed(5)
        state, m = step_case(cases, dp, tp, torch.float64, deferred, generator=gen)
        out[f"gen64/{deferred}"] = (lead((state.params, state.bn_state,
                                          state.ema_params, state.opt_state["mu"],
                                          state.opt_state["nu"])), m)
        out[f"draws/{deferred}"] = lead(gen.get_state().long())
    out["gen32"] = step_case(cases, dp, tp, torch.float32)[1]
    if dp.world == 1:
        local, grads, m = grads_case(cases, dp, tp)
        repl = [g for g, s in zip(tree_leaves(local), sharded_leaves(local)) if not s]
        out["grads"] = (lead(grads), lead(repl)[1], m)
        state, m = step_case(cases, dp, tp, torch.float64, name="taco1")
        out["taco1"] = (lead((state.params, state.bn_state))[0], m)
        out["bf16"] = step_case(cases, dp, tp, torch.float32,
                                extra="compute_dtype=bfloat16")[1]
        out["ops"] = op_case(tp)
    torch.save(out, os.path.join(workdir, f"out-{world}-{rank}.pt"))
    dist.destroy_process_group()


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
from nspeech_tpu.data.feeder import Batch as JBatch  # noqa: E402
from nspeech_tpu.models import create_model as j_create  # noqa: E402
from nspeech_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from nspeech_tpu.parallel import shard_batch as j_shard_batch  # noqa: E402
from nspeech_tpu.parallel.tensor import shard_train_state as j_shard_state  # noqa: E402
from nspeech_tpu.parallel.tensor import spec_for_path as j_spec  # noqa: E402
from nspeech_tpu.train import loop as jloop  # noqa: E402
from nspeech_tpu.train.optim import make_optimizer as j_make_optimizer  # noqa: E402
from nspeech_tpu_torch import convert  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_cases():
    """The inputs (torch) of every case, and the JAX model, weights and
    batch they were bridged from."""
    rng = np.random.default_rng(0)
    lengths = np.array([8, 6, 5, 3], np.int32)
    frames = np.array([10, 9, 6, 4])
    ids = rng.integers(2, 60, (ROWS, 8)).astype(np.int32)
    ids[np.arange(8)[None] >= lengths[:, None]] = 0
    mel = rng.random((ROWS, 10, 80), dtype=np.float32)
    lin = rng.random((ROWS, 10, 1025), dtype=np.float32)
    mel[np.arange(10)[None] >= frames[:, None]] = 0.0
    lin[np.arange(10)[None] >= frames[:, None]] = 0.0
    spk = np.array([0, 2, 1, 2], np.int32)
    cases = {"batch": {
        "inputs": torch.from_numpy(ids).long(),
        "input_lengths": torch.from_numpy(lengths).long(),
        "speaker_ids": torch.from_numpy(spk).long(),
        "mel_targets": torch.from_numpy(mel),
        "linear_targets": torch.from_numpy(lin)}}
    jx = {"batch": JBatch(jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(spk),
                          jnp.asarray(mel), jnp.asarray(lin),
                          jnp.zeros((ROWS, 16), jnp.float32))}
    for name in ("taco2", "taco1"):
        jcfg = j_load(name).parse(",".join([TINY if name == "taco2" else TACO1,
                                            NO_GEN]))
        jm = j_create(name, jcfg)
        jp, js = jm.init(jax.random.PRNGKey(0))
        tp_, ts = convert.tacotron_variables(model_of(name, NO_GEN)[1],
                                             np_tree(jp), np_tree(js))
        cases[name] = {"params": tp_, "bn_state": ts}
        jx[name] = (jcfg, jm, jp, js)
    return cases, jx


class Runs:
    """The cases, and the workers of both grids (started at once)."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="torch_tensor_parallel_")
        self.cases, self.jax = make_cases()
        torch.save(self.cases, os.path.join(self.dir, "cases.pt"))
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        self.procs = {}
        for d in DATA:
            world, port = d * M, _free_port()
            self.procs[d] = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), self.dir, str(r),
                 str(world), str(port)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=REPO) for r in range(world)]
        self.outs = {}
        self._memo = {}

    def memo(self, key, fn):
        """``fn()``, once per key: the references both grids are held to."""
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def get(self, d):
        """The outputs of each rank of the grid of ``d`` data ranks (waits
        for them)."""
        if d not in self.outs:
            logs = [p.communicate(timeout=300)[0] for p in self.procs[d]]
            for r, (p, log) in enumerate(zip(self.procs[d], logs)):
                assert p.returncode == 0, f"rank {r} of {d} x {M}:\n{log[-3000:]}"
            self.outs[d] = [torch.load(
                os.path.join(self.dir, f"out-{d * M}-{r}.pt"), weights_only=False)
                for r in range(d * M)]
        return self.outs[d]


@pytest.fixture(scope="module")
def runs():
    r = Runs()
    try:
        yield r
    finally:
        for procs in r.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        shutil.rmtree(r.dir, ignore_errors=True)


def leaf_gap(ref, got, moved=False):
    """The worst leaf of |got - ref| over the leaf's largest |ref|. A conv
    bias that feeds batch norm with no activation between (at these
    widths every conv: each stack has one) has a gradient that cancels to
    rounding noise, exactly 0 in exact arithmetic: it is measured against
    its conv kernel (as ``test_torch_parallel.py``), and in a tree of
    ``moved`` parameters (after the step: params, EMA) absolutely. Adam's
    first step divides that noise (~1e-17 here) by its eps (1e-8), so
    such a bias moves by ~1e-11 in either step, and by different amounts
    in two orders of summation."""
    ref, got = dict(named_leaves(ref)), dict(named_leaves(got))
    assert ref.keys() == got.keys()
    worst = 0.0
    for path, r in ref.items():
        scale = r.double().abs().max().item()
        if path.endswith("/conv/bias"):
            scale = 1.0 if moved else ref[path[:-4] + "kernel"].double().abs().max().item()
        err = (got[path].double() - r.double()).abs().max().item()
        worst = max(worst, err / max(scale, 1e-300))
    return worst


def close_rel(a, b, rtol):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["taco2", "taco1"])
def test_rules_match_jax_by_path(name):
    """(a): every leaf of the full-width tree has JAX's path, shape and
    spec; the port's Tacotron-1 shards none."""
    jtree = jax.eval_shape(j_create(name, j_load(name)).init,
                           jax.random.PRNGKey(0))[0]
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    model = create_model(name, t_load(name))
    tree = model.init(0)[0]
    tleaves = leaves_with_path(tree)
    assert len(jleaves) == len(tleaves)
    for (jpath, jleaf), (tpath, tleaf) in zip(jleaves, tleaves):
        path = jax.tree_util.keystr(jpath)
        assert keystr(tpath) == path
        assert tuple(tleaf.shape) == tuple(jleaf.shape), path
        assert spec_for_path(path) == tuple(j_spec(path)), path
    specs = [spec_for_path(keystr(p)) for p, _ in tleaves]
    if name == "taco2":
        assert sum(bool(s) for s in specs) == 75
        # the full widths divide over 2 and 4 model ranks
        for world in (2, 4):
            shard = shard_params(tree, TensorParallel(world - 1, world, "cpu"))
            assert shard["lstm1"]["kernel"].shape == (1792, 4096 // world)
            assert shard["linear_proj"]["kernel"].shape == (512 // world, 1025)
    else:
        # JAX's rules match eight Tacotron-1 leaves; the port keeps
        # Tacotron-1 replicated along the model axis
        assert sum(bool(s) for s in specs) == 8
        assert not any(sharded_leaves(tree, model.tp_rules))


@pytest.mark.parametrize("world", [2, 4])
def test_shard_merge_is_exact(runs, world):
    """(b): the slices put back are the tree, bit for bit; each rank holds
    its units of each gate and its forward and backward rows of
    ``linear_proj``."""
    params = runs.cases["taco2"]["params"]
    shards = [shard_params(params, TensorParallel(r, world, "cpu"))
              for r in range(world)]
    merged = merge_params(shards)
    for (path, a), b in zip(named_leaves(params), tree_leaves(merged)):
        assert torch.equal(a, b), path
    H = 32 // world             # decoder units of each rank
    for r, s in enumerate(shards):
        k = s["lstm1"]["kernel"]
        whole = params["lstm1"]["kernel"]
        for g in range(4):
            assert torch.equal(k[:, g * H:(g + 1) * H],
                               whole[:, g * 32 + r * H:g * 32 + (r + 1) * H])
        e = 8 // world          # expand units of each rank
        assert torch.equal(s["linear_proj"]["kernel"], torch.cat([
            params["linear_proj"]["kernel"][r * e:(r + 1) * e],
            params["linear_proj"]["kernel"][8 + r * e:8 + (r + 1) * e]]))
        assert s["embedding"]["table"] is params["embedding"]["table"]
    if world == M:
        assert all(out["gathered_equal"] for d in DATA for out in runs.get(d))


def test_indivisible_width_raises(runs):
    with pytest.raises(ValueError, match=r"^\['\w+'\].*: axis \d of width 16 "
                       r"does not divide over 3 model ranks$"):
        shard_params(runs.cases["taco2"]["params"], TensorParallel(0, 3, "cpu"))
    with pytest.raises(ValueError, match=r"\['attention'\]\['location_layer'\]"
                       r"\['kernel'\]: axis 1 of width 16 does not divide over 3"):
        attention = runs.cases["taco2"]["params"]["attention"]
        shard_params({"attention": {"location_layer": attention["location_layer"]}},
                     TensorParallel(2, 3, "cpu"))
    # 48 gates divide over 8 ranks, 12 units of each gate do not
    with pytest.raises(ValueError, match=r"\['lstm1'\]\['bias'\]: axis 0 of width "
                       r"48 does not divide over 8 model ranks in 4 blocks"):
        shard_params({"lstm1": {"bias": torch.zeros(48)}},
                     TensorParallel(0, 8, "cpu"))


@pytest.mark.parametrize("d", DATA)
def test_grid_layout(runs, d):
    """Rank d * M + m is data shard d and model rank m, as JAX's
    ``make_mesh`` lays out devices."""
    for rank, out in enumerate(runs.get(d)):
        assert out["grid"] == (rank // M, d, rank % M, M)


@pytest.mark.parametrize("d,deferred", [(d, f) for d in DATA for f in (True, False)])
def test_tp_step_matches_single_device(runs, d, deferred):
    """(c): the (d x 2) step is the single-device step on the global
    batch."""
    ref_state, ref_m = runs.memo(f"gen64/{deferred}", lambda: step_case(
        runs.cases, None, None, torch.float64, deferred))
    ref32 = runs.memo("gen32", lambda: step_case(
        runs.cases, None, None, torch.float32)[1])
    outs = runs.get(d)
    (trees, _), _ = outs[0][f"gen64/{deferred}"]
    refs = (ref_state.params, ref_state.bn_state, ref_state.ema_params,
            ref_state.opt_state["mu"], ref_state.opt_state["nu"])
    for field, ref, tree in zip(("params", "bn_state", "ema", "mu", "nu"), refs, trees):
        gap = leaf_gap(ref, tree, field in ("params", "ema"))
        assert gap <= 1e-10, (field, gap)
    def draws():
        gen = torch.Generator().manual_seed(5)
        step_case(runs.cases, None, None, torch.float64, deferred, generator=gen)
        return gen.get_state().long()

    ref_draws = runs.memo(f"draws/{deferred}", draws)
    for r, out in enumerate(outs):
        (_, worst), m = out[f"gen64/{deferred}"]
        assert worst == 0.0, r     # every rank leaves with rank 0's state
        # every rank drew what the single-device step draws, no more
        assert out[f"draws/{deferred}"][1] == 0, r
        if r == 0:
            assert torch.equal(out[f"draws/{deferred}"][0], ref_draws)
        for k in ("loss", "loss_guided_attention", "grad_norm"):
            close_rel(m[k], ref_m[k], 1e-10)
        norms = ref_m["grad_norms"]
        assert (m["grad_norms"] - norms).abs().max() <= 1e-10 * norms.max()
        for k, v in ref32.items():
            if isinstance(v, torch.Tensor) and v.ndim == 0:
                close_rel(out["gen32"][k], v, 1e-6)


def capture(tx):
    """An optax stage in front of ``tx`` that keeps the gradients it is
    given in its state (as ``test_torch_parallel.py``)."""
    def init(params):
        return ({"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
                tx.init(params))

    def update(g, state, params=None):
        u, s = tx.update(g, state[1], params)
        return u, ({"g": g}, s)

    return optax.GradientTransformation(init, update)


def test_tp_grads_match_jax_tp_step(runs):
    """(d): the (1 x 2) gradients against JAX's tensor-parallel step on its
    (4 x 2) mesh (``shard_train_state``, as ``test_tensor_parallel.py``)."""
    jcfg, jm, jp, js = runs.jax["taco2"]
    jtx, jsched = j_make_optimizer(jcfg, "taco2")
    mesh = j_make_mesh(model_parallel=2)
    jstep = jloop.build_tacotron_train_step(jm, capture(jtx), schedule=jsched)
    jstate = j_shard_state(jloop.TrainState(jnp.zeros((), jnp.int32), jp, js,
                                            capture(jtx).init(jp)), mesh)
    assert not jstate.params["lstm1"]["kernel"].sharding.is_fully_replicated
    jstate, jmet = jstep(jstate, j_shard_batch(runs.jax["batch"], mesh),
                         jax.random.PRNGKey(1))
    jl = jax.tree_util.tree_leaves_with_path(jstate.opt_state[0]["g"])
    outs = runs.get(1)
    (grads, _), _, _ = outs[0]["grads"]
    tl = named_leaves(grads)
    assert len(jl) == len(tl)
    ref = {p: torch.from_numpy(np.array(j)) for (_, j), (p, _) in zip(jl, tl)}
    assert leaf_gap(ref, dict(tl)) <= 1e-2
    err = sum(torch.sum((t.double() - ref[p].double()) ** 2) for p, t in tl)
    norm = sum(torch.sum(r.double() ** 2) for r in ref.values())
    assert (err / norm).sqrt() <= 1e-4, float((err / norm).sqrt())
    for out in outs:
        (_, worst), repl_worst, metrics = out["grads"]
        assert worst == 0.0 and repl_worst == 0.0
        close_rel(metrics["loss"], jmet["loss"], 2e-5)


@pytest.mark.parametrize("op", ["copy", "reduce", "gather"])
def test_model_axis_operator_backward(runs, op):
    """(e): each rank's gradient of its input: ``copy`` the sum of the
    ranks' partial gradients, ``reduce`` the gradient of the sum itself,
    ``gather`` the rank's slice of the whole gradient."""
    x, w, W = op_inputs(M)
    for r, out in enumerate(runs.get(1)):
        want = {"copy": w.sum(dim=0), "reduce": W[:, :4],
                "gather": W[:, r * 4:(r + 1) * 4]}[op]
        torch.testing.assert_close(out["ops"][op], want, rtol=0, atol=1e-15)


def test_taco1_runs_replicated(runs):
    """Tacotron-1 under a model axis: no leaf is sharded, and the step is
    the plain one."""
    ref_state, ref_m = runs.memo("taco1", lambda: step_case(
        runs.cases, None, None, torch.float64, name="taco1"))
    outs = runs.get(1)
    params, bn = outs[0]["taco1"][0]
    assert leaf_gap(ref_state.params, params) <= 1e-10
    assert leaf_gap(ref_state.bn_state, bn) <= 1e-10
    for out in outs:
        close_rel(out["taco1"][1]["loss"], ref_m["loss"], 1e-10)


def test_bf16_tp_step(runs):
    """The bf16 policy's flat cast on a sharded tree: the (1 x 2) bf16
    step's loss is finite and within BF16_TOL of the plain bf16 step's."""
    ref = runs.memo("bf16", lambda: step_case(
        runs.cases, None, None, torch.float32, extra="compute_dtype=bfloat16")[1])
    for out in runs.get(1):
        assert torch.isfinite(out["bf16"]["loss"])
        close_rel(out["bf16"]["loss"], ref["loss"], BF16_TOL)
