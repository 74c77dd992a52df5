"""The program's own spans (``nspeech_tpu_torch.utils.profiling``), for
the readers of ``program_span`` metrics. The program records them only
while a profile runs, so after a traced run they cover its traced
window. A program without the recorder, or a window without the span,
reads None."""

from __future__ import annotations


def of(name: str):
    """The records of span ``name`` (``t0_ns``, ``t1_ns``, ``parent``,
    ``thread``, ``attrs``), or None where there are none, or where the
    recorder's buffer dropped records (a part of the window would read
    as the whole)."""
    from nspeech_tpu_torch.utils import profiling
    get = getattr(profiling, "spans", None)
    if get is None or profiling.dropped():
        return None
    return get(name) or None


def seconds(rec) -> float:
    return (rec.t1_ns - rec.t0_ns) * 1e-9


def ms_per_step(run, name: str):
    """Milliseconds of span ``name`` per traced step of a training run."""
    recs = of(name)
    steps = run.info.get("traced", {}).get("steps")
    if recs is None or not steps:
        return None
    return 1000.0 * sum(seconds(r) for r in recs) / steps
