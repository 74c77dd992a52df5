"""Kernel (csrc/wavenet_gen.cu, carried form K4): percent of its
roofline. The least time is the larger of its FLOPs over the float32
peak (3.45 MFLOP per delivered sample and real stream, padded rows not
counted) and its bytes over the memory peak (the weights and each real
stream's rings once per launch, each delivered sample's conditioning and
code once); the time is the device time of the sampler's kernels in the
trace."""

import torch

from benchmark.harness import flops


def read(run, ctx):
    if run.trace is None:
        return None
    secs = sum(v[1] for k, v in run.trace["kernels"].items() if "wavenet_sample" in k)
    if secs <= 0:
        return None
    wn = ctx.config["wavenet"]
    samples = run.info["flops"]["samples"]
    peak_f, peak_b = flops.peaks(torch.cuda.get_device_name(0))
    f = flops.sampler_sample_flops(wn) * samples
    b = (sum(g.get("launches", 0) * flops.sampler_launch_bytes(wn, g["n"], 0)
             for g in run.info["groups"])
         + samples * 4 * (wn["lc_channels"] + 1))
    return 100.0 * max(f / peak_f, b / peak_b) / secs
