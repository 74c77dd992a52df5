"""The vocoder training cell (``wavenet.train``) at small sizes on the CPU:
a run is correct and reports its metrics; each planted fault (a loss over
half the batch, a step that keeps its parameters) reads not correct;
the control, the reference in TF32 in the program's place, reads far
above the program; the frozen FLOP count at the recipe's widths."""

import pytest

from benchmark import control
from benchmark.harness import core, flops, runner, wavenet_flops
from conftest import small_ctx

CELL = "wavenet.train"
MAN = core.manifest()
TRAFFIC = core.module("traffic", "wavenet_train")
# windows of 9 + 256 samples at the small sample rate, two to a batch
SMALL = dict(sample_size=256, batch_size=2)


def _ctx():
    ctx = small_ctx(CELL)
    ctx.config["wavenet"].update(SMALL)
    return ctx


def test_small_run_is_correct_with_its_metrics():
    ends = core.metrics_of(MAN, CELL, False)
    assert {m["name"] for m in ends} == {"train_audio_s_per_s", "setup_s"}
    res = runner.execute(_ctx(), core.now(), ends, TRAFFIC)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 3 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in ends}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["compared"]["windows_wrong"]["value"] == 0
    assert res["compared"]["feature_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", sorted(TRAFFIC.FAULTS))
def test_planted_fault_is_not_correct(fault):
    with TRAFFIC.FAULTS[fault]():
        res = runner.execute(_ctx(), core.now(), [], TRAFFIC)
    assert not res["correct"], res["compared"]
    if fault == "state_unchanged":
        assert res["compared"]["change_leaf_gap"]["value"] > 0.9


def test_control_reads_far_above_the_program():
    got = control.readings(_ctx(), TRAFFIC)
    ratios = [got["control"][k] / max(got["program"][k], 1e-12)
              for k in got["control"] if got["control"][k] > 0]
    assert ratios and max(ratios) > 30, got


def test_flop_count_at_the_recipe():
    c = core.config("wavenet_vocoder")["wavenet"]
    per_sample = wavenet_flops.forward_flops(c) / c["sample_size"]
    # the sampler's 3.45 MFLOP per sample, plus the layers' extra positions
    assert flops.sampler_sample_flops(c) < per_sample < 1.05 * flops.sampler_sample_flops(c)
    assert 0.85e12 < wavenet_flops.train_step_flops(c, c["batch_size"]) < 0.95e12
