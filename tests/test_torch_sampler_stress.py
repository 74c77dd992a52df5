"""The plain reference of ``scripts/torch_sampler_stress.py`` on the CPU:
``plain_logits`` (the plain generator's step at every step at once, from
the kernel's own input codes) against the logits of the port's
``WaveNet.generate`` (the plain version the kernel checks use) at tiny
widths with speakers and local conditioning, within 1e-5; and
``score_gap`` scoring the generator's own codes at 0 with no differing
argmax, at temperature 0 and 1 (Philox noise)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from nspeech_tpu_torch.config import load_config
from nspeech_tpu_torch.models import WaveNet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = importlib.util.spec_from_file_location(
    "torch_sampler_stress", os.path.join(ROOT, "scripts", "torch_sampler_stress.py"))
stress = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(stress)

TINY = ("dilations_length=4,dilations_depth=2,residual_channels=8,"
        "dilation_channels=8,skip_channels=16,quantization_channels=32,"
        "lc_channels=5,gc_channels=4,gc_category_cardinality=3")


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_plain_logits_match_the_generator(temperature):
    net = WaveNet(load_config("wavenet").parse(TINY))
    params = net.init(1)
    lc = torch.tensor(np.random.default_rng(0).random((2, 60, 5)),
                      dtype=torch.float32)
    codes, logits = net.generate(params, 60, seed=3, batch=2, gc_ids=[0, 2],
                                 lc=lc, temperature=temperature,
                                 return_logits=True)
    inputs = torch.cat([torch.full((2, 1), 16, dtype=torch.int32),
                        codes[:, :-1]], dim=1)
    got = stress.plain_logits(net, params, inputs, [0, 2], lc)
    assert got.shape == logits.shape
    torch.testing.assert_close(got, logits, rtol=0, atol=1e-5)
    gap, first = stress.score_gap(net, params, codes, inputs, [0, 2], lc,
                                  temperature, 3)
    assert gap <= 1e-5 and first is None
