"""Whole runs of each cell at small sizes on the CPU, past the look for a
card: correct as served, and not correct with the timed path broken
where its answers are produced (the faults of each traffic driver, and
for training a step that returns its state unchanged). The control, the
reference in TF32 in the program's place, reads far above the program
on each cell."""

import contextlib

import pytest

from benchmark import control
from benchmark.harness import core, runner
from conftest import small_ctx

CELLS = ["t2wn.stream", "t1gl.oneshot", "t2wn.train"]
MAN = core.manifest()


def _metrics(cell):
    """The cell's end-to-end metrics; for a cell the manifest does not run,
    those its metric files give (its one tail and set-up)."""
    if cell in [w["name"] for w in MAN["workloads"]]:
        return core.metrics_of(MAN, cell, False)
    return [{"name": "latency_p90_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct_with_its_metrics(cell):
    ctx = small_ctx(cell)
    res = runner.execute(ctx, core.now(), _metrics(cell))
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in _metrics(cell)}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def _faults():
    for cell in CELLS:
        driver = core.module("traffic", core.workload(cell)["kind"])
        for name in driver.FAULTS:
            yield cell, name


@pytest.mark.parametrize("cell,fault", list(_faults()))
def test_planted_fault_is_not_correct(cell, fault):
    ctx = small_ctx(cell)
    driver = core.module("traffic", ctx.params["kind"])
    with driver.FAULTS[fault]():
        res = runner.execute(ctx, core.now(), [], driver)
    assert not res["correct"], res["compared"]


@contextlib.contextmanager
def _state_unchanged():
    from nspeech_tpu_torch.train import loop
    orig = loop.build_tacotron_train_step

    def build(*a, **k):
        step = orig(*a, **k)

        def same(state, batch, generator):
            new, metrics = step(state, batch, generator)
            return state._replace(step=new.step, opt_state=new.opt_state), metrics
        return same

    loop.build_tacotron_train_step = build
    try:
        yield
    finally:
        loop.build_tacotron_train_step = orig


def test_train_step_that_keeps_its_state_is_not_correct():
    ctx = small_ctx("t2wn.train")
    driver = core.module("traffic", "train_loop")
    with _state_unchanged():
        res = runner.execute(ctx, core.now(), [], driver)
    assert not res["correct"]
    assert res["compared"]["change_leaf_gap"]["value"] > 0.9


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program(cell):
    ctx = small_ctx(cell)
    driver = core.module("traffic", ctx.params["kind"])
    got = control.readings(ctx, driver)
    ratios = [got["control"][k] / max(got["program"][k], 1e-12)
              for k in got["control"] if got["control"][k] > 0]
    assert ratios and max(ratios) > 30, got
