"""An open loop of requests: each is sent at its scheduled time whatever
the state of the earlier ones, by a thread of its own, and timed from
when it was due. The loop reports how late it sent."""

from __future__ import annotations

import threading
import time
from typing import Callable, List

from benchmark.harness.core import now


def drive(times, texts, client: Callable[[dict], None], start: float,
          drain_s: float) -> List[dict]:
    """Send request i at ``start + times[i]`` by calling ``client(rec)``
    in a new thread; ``rec`` holds ``i``, ``text``, ``due`` and ``sent``
    (host clock) and the client adds its own times, or ``error``. Returns
    the records once every client has ended, or marks those still running
    ``drain_s`` after the last send as failed (their threads are daemons
    blocked on a queue that closing the batcher ends)."""
    recs, threads = [], []
    for i, (t, text) in enumerate(zip(times, texts)):
        due = start + float(t)
        wait = due - now()
        if wait > 0:
            time.sleep(wait)
        rec = {"i": i, "text": text, "due": due, "sent": now()}
        recs.append(rec)

        def run(rec=rec):
            try:
                client(rec)
            except Exception as e:        # counted as failed, reported
                rec["error"] = repr(e)

        th = threading.Thread(target=run, daemon=True, name=f"client-{i}")
        th.start()
        threads.append(th)
    deadline = now() + drain_s
    for th in threads:
        th.join(timeout=max(0.0, deadline - now()))
    for rec, th in zip(recs, threads):
        if th.is_alive():
            rec["error"] = "no answer within the drain"
    return recs


def lateness(recs) -> float:
    """The largest delay of a send behind its schedule, seconds."""
    return max((r["sent"] - r["due"] for r in recs), default=0.0)

