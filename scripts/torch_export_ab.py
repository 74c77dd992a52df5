"""Compare the two decode loops a Tacotron-2 serving artifact could hold.

    python3 scripts/torch_export_ab.py [--max-iters N] [--out-dir DIR]

Exports the full-width Tacotron-2 (``taco2`` preset, seeded weights,
``max_iters`` N, 40 by default) twice through ``serving/export.py`` on the
card: with the decode as one ``while_loop`` that exits when every row has
stopped (``models/decoder.py`` ``while_autoregressive``, what
``export_synthesizer`` ships) and as ``max_iters`` steps unrolled into
the graph (``start_autoregressive`` and one ``scan_autoregressive_chunk``
of ``max_iters - 1`` steps, which never asks the host). For each it
prints the export time (trace and save), the artifact's size, the load
time, the request latency (median of REPS requests after one warm-up,
each ending in a sync), the host syncs per request (calls of
``aten::_local_scalar_dense`` in a profiled request) and whether the mel
equals the live ``Synthesizer``'s; the live path's latency and syncs
beside them, in turns live, while, unrolled, live. Ends with one JSON line
and the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 5
TEXT = "The quick brown fox jumps over the lazy dog."


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def unrolled_autoregressive(step, carry0, batch, num_mels, r, max_iters,
                            stop_threshold=0.0, initial_finished=None):
    """``scan_autoregressive`` as ``max_iters`` steps in one chunk."""
    import torch

    from nspeech_tpu_torch.models.decoder import (scan_autoregressive_chunk,
                                                  start_autoregressive)

    (out, align), carry = start_autoregressive(
        step, carry0, batch, num_mels, max_iters, stop_threshold,
        initial_finished)
    (outs, aligns), carry = scan_autoregressive_chunk(
        step, carry, max_iters - 1, num_mels, stop_threshold)
    return (torch.cat([out[None], outs]), torch.cat([align[None], aligns]),
            carry[4])


def latency(fn, reps: int = REPS):
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def host_syncs(fn) -> int:
    """Calls of ``aten::_local_scalar_dense`` (a device value read by the
    host) in one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::_local_scalar_dense")


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--max-iters", type=int, default=40)
    parser.add_argument("--out-dir", default=None,
                        help="Where the artifacts go (default: a temporary dir)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    from nspeech_tpu_torch.config import load_config
    from nspeech_tpu_torch.models.tacotron2 import Tacotron2
    from nspeech_tpu_torch.serving import ExportedSynthesizer, Synthesizer
    from nspeech_tpu_torch.serving import export as E

    class Unrolled(E._SynthesizerProgram):
        @staticmethod
        def decode():
            return unrolled_autoregressive

    card = card_line()
    print(card, "torch", torch.__version__, "cuda", torch.version.cuda)
    cfg = load_config("taco2").parse(f"max_iters={args.max_iters}")
    model = Tacotron2(cfg)
    params, bn = model.init(1)
    syn = Synthesizer(cfg, text_bucket=64).set_variables(params, bn, model=model)
    _, mel_live, _ = syn.synthesize(TEXT)
    out_root = args.out_dir or tempfile.mkdtemp()
    dev = syn.device
    example = (torch.zeros(1, 64, dtype=torch.int64, device=dev),
               torch.ones(1, dtype=torch.int64, device=dev),
               torch.zeros(1, dtype=torch.int64, device=dev))
    meta = {"batch": 1, "text_len": 64, "platforms": ["cuda"],
            "cleaners": cfg.cleaners, "preemphasis": float(cfg.preemphasis),
            "preemphasis_in_program": True, "sample_rate": int(cfg.sample_rate),
            "min_silence_sec": 0.8, "silence_threshold_db": -40.0,
            "num_speakers": int(cfg.num_speakers)}
    result = {"card": card, "torch": torch.__version__,
              "max_iters": args.max_iters, "designs": {}}
    served = {}
    for name, cls in (("while_loop", E._SynthesizerProgram), ("unrolled", Unrolled)):
        out = os.path.join(out_root, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        E._save(cls(syn, 1), example, out, E.MODULE_FILE, E.META_FILE, meta)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(out, E.MODULE_FILE))
        t0 = time.perf_counter()
        served[name] = ExportedSynthesizer(out)
        load_s = time.perf_counter() - t0
        _, mel, _ = served[name].synthesize(TEXT)
        result["designs"][name] = {
            "export_s": export_s, "artifact_bytes": size, "load_s": load_s,
            "mel_equal_live": bool(np.array_equal(mel, mel_live)),
            "mel_max_abs_diff": float(np.abs(mel - mel_live).max())}
        print(f"{name}: export {export_s:.3f} s, artifact {size / 1e6:.1f} MB, "
              f"load {load_s:.3f} s, mel equal to live "
              f"{result['designs'][name]['mel_equal_live']} [{card}]")
    turns = [("live", lambda: syn.synthesize(TEXT))] + [
        (name, (lambda ex: lambda: ex.synthesize(TEXT))(ex))
        for name, ex in served.items()]
    times = {name: [] for name, _ in turns}
    for name, fn in turns + turns[::-1]:
        times[name] += latency(fn)[1]
    for name, fn in turns:
        med = statistics.median(times[name])
        syncs = host_syncs(fn)
        entry = result["designs"].setdefault(name, {})
        entry.update({"latency_s": med, "latency_all_s": times[name],
                      "host_syncs": syncs})
        print(f"{name}: request {med:.4f} s (median of {len(times[name])}), "
              f"host syncs {syncs} for {args.max_iters} decoder steps [{card}]")
    print(json.dumps(result))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
