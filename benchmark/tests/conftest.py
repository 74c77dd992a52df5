"""Small configurations of the benchmark's cells for CPU tests: the cells'
own traffic kinds and parameters at a few decoder steps, a small sample
rate and narrow widths."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark.harness import core

TACO2 = dict(embedding_dim=16, encoder_conv_channels=16, encoder_conv_layers=2,
             encoder_lstm_units=8, attention_dim=16, decoder_lstm_units=16,
             postnet_conv_layers=2, postnet_conv_channels=16,
             expand_conv_layers=2, expand_conv_channels=16, expand_lstm_units=8)
AUDIO = dict(num_mels=8, num_freq=65, sample_rate=2000, outputs_per_step=2,
             griffin_lim_iters=4)
TACO1 = dict(embedding_dim=16, encoder_prenet=[16, 16], encoder_cbhg_banks=3,
             encoder_cbhg_bank_sizes=[16, 16], attention_dim=16, decoder_dim=16,
             post_cbhg_banks=2, post_cbhg_bank_sizes=[16])
WAVENET = dict(dilations_depth=1, dilations_length=3, residual_channels=8,
               dilation_channels=8, skip_channels=16, quantization_channels=32,
               lc_channels=8)
CELL = dict(decode_steps=6, chunk_frames=4, text_min=10, text_max=30,
            text_bucket=8, check_requests=3, drain_s=60, max_batch=4,
            corpus_clips=16, clip_min_s=0.3, clip_max_s=1.0, clip_mean_s=0.6,
            chars_per_s=30.0, frame_bucket=10, setup_steps=3)
TRAIN = dict(batch_size=4, batch_group_size=2)


def small_config(name: str) -> dict:
    cfg = copy.deepcopy(core.config(name))
    for key, over in (("taco2", {**AUDIO, **TACO2, **TRAIN}), ("taco1", {**AUDIO, **TACO1}),
                      ("wavenet", {**AUDIO, **WAVENET})):
        if key in cfg:
            cfg[key].update(over)
    return cfg


# the configuration of a cell whose files are kept but that the manifest
# does not run (PERF.md, Open questions)
CONFIG_OF = {"t1gl.oneshot": "tacotron1_griffinlim"}


def small_ctx(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 3.0, **over):
    name = CONFIG_OF.get(cell) or core.cell_entry(core.manifest(), cell)["config"]
    params = copy.deepcopy(core.workload(cell))
    params.update({k: v for k, v in CELL.items() if k in params})
    params.update(over)
    return core.Ctx(cell=cell, params=params, config=small_config(name),
                    seed=seed, seconds=seconds, trace=False, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
