"""The benchmark of nspeech_tpu_torch on NVIDIA GPUs: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then the correctness comparison under ``compared``. The
numbers compared, each beside its limit, are also the last lines of
standard error. Exits 1 without a result when no card is present (or
fewer than the cell asks for), when the run loaded JAX or the JAX
package, or when the program is missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX side of any
    library."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from benchmark.harness import core, runner

    man = core.manifest()
    entry = core.cell_entry(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: the cell {args.workload} needs {entry['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    params = core.workload(args.workload)
    ctx = core.Ctx(cell=args.workload, params=params,
                   config=core.config(entry["config"]), seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), device="cuda")
    result = runner.execute(ctx, T_START,
                            core.metrics_of(man, args.workload, bool(args.trace)))
    found = runner.forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 1
    for k, v in result.pop("counters").items():
        print(f"counter {k} = {v!r}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
