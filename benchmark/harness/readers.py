"""Shared arithmetic of the metric readers: percentiles over a run's
requests, the trace's shares, the peak of the run's card."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import flops


def pct(values, q: float):
    """The q-th percentile (0-100, linear interpolation), None without
    values."""
    values = [v for v in values if v is not None]
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def latency(run, key: str):
    """Seconds from each request's due time to its ``key`` time; a request
    that failed counts as the whole window and its drain."""
    limit = run.window_s + float(run.info.get("drain_s", 0.0))
    return [(r[key] - r["due"]) if "error" not in r and key in r else limit
            for r in run.records]


def device_idle(run):
    """Percent of the traced window in which no operation ran on the card."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def peak_flops() -> float:
    return flops.peaks(torch.cuda.get_device_name(0))[0]


def share(flop_count: float, seconds: float):
    """Percent of the card's float32 peak that ``flop_count`` FLOPs in
    ``seconds`` reach."""
    if seconds <= 0 or not flop_count:
        return None
    return 100.0 * flop_count / (seconds * peak_flops())
