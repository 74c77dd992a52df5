"""The device trace of a traced run (``--trace 1``), by ``torch.profiler``.

:class:`Tracer` profiles the CPU and the card between :meth:`start` and
:meth:`stop`, both taken after a device synchronise, and reduces the
trace to what the metric readers need: the seconds in which an
operation ran on the card (the union of the intervals of the kernels and
copies; not of the card-side projections of the harness's annotations or
of synchronisation records), the length of the traced window on the host clock, each
kernel name's count and device seconds, the kernel launches, and the
longest idle gaps of the card, each named by what the host was doing in
it (the CPU operation that overlaps it longest, the innermost of equals,
under the harness's outermost span that overlaps it)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.core import now

SPAN_PREFIX = "bench:"


COPIES = ("Memcpy", "Memset")


class Tracer:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = now()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = now()
        self.prof.__exit__(None, None, None)

    def summary(self, top: int = 10) -> dict:
        """busy_s, window_s, kernels {name: [count, seconds]}, launches,
        device_ops and idle_gaps (the ``breakdown``)."""
        dev, cpu = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            item = (e.start_ns(), e.duration_ns(), e.name())
            (dev if e.device_type() == cuda else cpu).append(item)
        # the card's projections of host annotations carry the host
        # event's name; kernels and copies never do
        host_names = {n for _, _, n in cpu}
        dev_s, dev_e = [], []
        kernels: Dict[str, List[float]] = {}
        launches = 0
        for s, d, name in dev:
            if name in host_names:
                continue
            dev_s.append(s)
            dev_e.append(s + d)
            if not name.startswith(COPIES):
                launches += 1
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += d * 1e-9
        cpu_s = [s for s, _, _ in cpu]
        cpu_e = [s + d for s, d, _ in cpu]
        cpu_n = [n for _, _, n in cpu]
        cpu_span = [n.startswith(SPAN_PREFIX) for n in cpu_n]
        window_s = self.t1 - self.t0
        if not dev_s:
            return {"busy_s": 0.0, "window_s": window_s, "kernels": {},
                    "launches": 0, "device_ops": [], "idle_gaps": []}
        order = np.argsort(dev_s)
        ds, de = np.asarray(dev_s)[order], np.asarray(dev_e)[order]
        # merge the device intervals: the union is the busy time
        run_end = np.maximum.accumulate(de)
        starts_new = np.concatenate([[True], ds[1:] > run_end[:-1]])
        m_s = ds[starts_new]
        m_e = np.concatenate([run_end[:-1][starts_new[1:]], run_end[-1:]])
        busy_s = float((m_e - m_s).sum() * 1e-9)
        cs, ce = np.asarray(cpu_s), np.asarray(cpu_e)
        lo = min(int(cs.min()) if len(cs) else int(m_s[0]), int(m_s[0]))
        hi = max(int(ce.max()) if len(ce) else int(m_e[-1]), int(m_e[-1]))
        g_s = np.concatenate([[lo], m_e])
        g_e = np.concatenate([m_s, [hi]])
        gap = g_e - g_s
        gaps = []
        span_mask = np.asarray(cpu_span, bool)
        for i in np.argsort(gap)[::-1][:top]:
            if gap[i] <= 0:
                break
            overlap = np.minimum(ce, g_e[i]) - np.maximum(cs, g_s[i])
            label = "host idle"
            ops = np.flatnonzero((overlap > 0) & ~span_mask)
            if len(ops):
                # longest overlap first, then the shortest (innermost) op
                best = ops[np.lexsort((ce[ops] - cs[ops], -overlap[ops]))[0]]
                label = cpu_n[best]
            spans = np.flatnonzero((overlap > 0) & span_mask)
            if len(spans):
                outer = cpu_n[spans[np.argmax(ce[spans] - cs[spans])]]
                label = outer[len(SPAN_PREFIX):] + " / " + label
            gaps.append([label, float(gap[i] * 1e-9)])
        ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
        return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
                "launches": launches,
                "device_ops": [[n[:160], v[1]] for n, v in ops],
                "idle_gaps": gaps}


class NoTracer:
    """The untraced run's stand-in."""

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


def span(name: str, traced: bool):
    """A ``record_function`` marker for a harness span in a traced run,
    a no-op context otherwise."""
    if traced:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    import contextlib
    return contextlib.nullcontext()
