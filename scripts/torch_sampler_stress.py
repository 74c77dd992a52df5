"""Run the WaveNet sampler kernel's first launches in many fresh processes.

    python3 scripts/torch_sampler_stress.py [--procs 40] [--out DIR] [--sanitize]

Each child process (``--child``) packs the full-width vocoder of
``chip_smoke.py`` (``chip_smoke.vocoder(0)``: wavenet hparams + lc 80,
gc 16, 4 speakers) and runs, in this order, the one-shot form K1 at B=1
and B=4 (per-stream speakers), each at temperature 0 and 1 with the
smoke's seeds and N_CHECK samples: a warm launch, then the checked
launch; then one primed launch (K3: PRIME_LEN seed codes, N_PRIMED kept)
and one stream of carried launches (K4: CARRY_SPLIT from the fresh
carry). Every launch's codes are checked in this order:

1. range: every code in [0, Q) (read before any code is used as an
   index; the first bad step and the codes' range are recorded);
2. determinism: the checked launch equals the warm launch, the primed
   launch equals the unprimed launch fed the same inputs, the carried
   launches equal one launch;
3. the plain version, teacher-forced: ``plain_logits`` computes the
   plain generator's step (``WaveNet._gen_step``) at every step at once
   from the kernel's own inputs, and every code must score within the
   smoke's SCORE_TOL of the best score (the same Philox noise).

The parent builds the kernel once, runs ``--procs`` children one after
another, and writes ``stress.json`` into ``--out`` (default
``build/stress``): pass or fail per process, the first bad case,
step and code range, and the machine (card, power limit, the card's
UUID, serial and bus id, driver, nvcc, torch). It saves ``nvidia-smi -q
-d ECC,PAGE_RETIREMENT,ROW_REMAPPER,PERFORMANCE,CLOCK`` before the first
process and beside each failure, with the Xid lines of ``dmesg`` it may
read. ``--sanitize`` then runs ``compute-sanitizer``
(racecheck, synccheck, initcheck, memcheck), where the toolkit has it,
on a child that makes one launch of each form of SANITIZE_T samples, and
records each tool's summary. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SANITIZE_T = 64          # samples per launch under compute-sanitizer
SANITIZE_TIMEOUT = 300   # seconds per tool
K1_CASES = ((1, None, 0.0), (1, None, 1.0), (4, [0, 1, 2, 3], 0.0),
            (4, [0, 1, 2, 3], 1.0))


def plain_logits(net, params, inputs, gc_ids, lc):
    """Logits [B, T, Q] of the plain generator (``WaveNet._gen_step``) at
    steps 0..T-1 from a fresh carry, fed ``inputs`` [B, T] as the input
    codes, computed for all steps at once: layer l's ring slot at step t
    holds its input at step t - d (zero for t < d)."""
    import torch

    w = params["causal"]
    x = inputs.long()
    current = w[1][x]
    current[:, 1:] = w[0][x[:, :-1]] + current[:, 1:]
    gc = net._embed_gc(params, gc_ids)
    steps = x.shape[1]
    skips = None
    for lp, d in zip(params["layers"], net.dilations):
        state = torch.nn.functional.pad(current, (0, 0, d, 0))[:, :steps]
        out_f = state @ lp["filter"][0] + current @ lp["filter"][1]
        out_g = state @ lp["gate"][0] + current @ lp["gate"][1]
        if gc is not None:
            out_f = out_f + (gc @ lp["gc_filter"][0])[:, None]
            out_g = out_g + (gc @ lp["gc_gate"][0])[:, None]
        if lc is not None:
            out_f = out_f + lc[:, :steps] @ lp["lc_filter"][0]
            out_g = out_g + lc[:, :steps] @ lp["lc_gate"][0]
        if net.use_biases:
            out_f = out_f + lp["filter_bias"]
            out_g = out_g + lp["gate_bias"]
        out = torch.tanh(out_f) * torch.sigmoid(out_g)
        transformed = out @ lp["dense"][0]
        skip = out @ lp["skip"][0]
        if net.use_biases:
            transformed = transformed + lp["dense_bias"]
            skip = skip + lp["skip_bias"]
        skips = skip if skips is None else skips + skip
        current = current + transformed
    h = torch.relu(skips) @ params["post1"][0]
    if net.use_biases:
        h = h + params["post1_bias"]
    logits = torch.relu(h) @ params["post2"][0]
    if net.use_biases:
        logits = logits + params["post2_bias"]
    return logits


def score_gap(net, params, codes, inputs, gc_ids, lc, temperature, seed,
              first_step=0):
    """(max score gap, first step whose argmax differs) of ``codes``
    [B, n], the codes of steps first_step.. of a launch fed ``inputs``."""
    import torch

    from nspeech_tpu_torch.ops.philox import gumbel_noise

    Q = net.quantization_channels
    scores = plain_logits(net, params, inputs, gc_ids, lc)[:, first_step:]
    n = codes.shape[1]
    scores = scores[:, :n]
    if temperature > 0:
        t = torch.arange(first_step, first_step + n, device=codes.device)
        scores = (scores * (1.0 / temperature)
                  + gumbel_noise(seed, t, codes.shape[0], Q).permute(1, 0, 2))
    chosen = scores.gather(-1, codes.long()[..., None])[..., 0]
    gap = (scores.max(dim=-1).values - chosen).max().item()
    differ = (scores.argmax(dim=-1) != codes.long()).nonzero()
    return gap, (None if differ.numel() == 0 else int(differ[:, 1].min()))


def child(n_k1: int, n_primed: int, prime_len: int, split) -> dict:
    """One fresh process's launches; returns its record."""
    import numpy as np
    import torch

    import chip_smoke as smoke
    from nspeech_tpu_torch.ops.cuda.wavenet_gen import CudaWaveNetGenerator
    from nspeech_tpu_torch.ops.policy import set_matmul_precision

    set_matmul_precision("highest")
    _, net, params = smoke.vocoder(0)
    Q = net.quantization_channels
    mid = lambda b: torch.full((b, 1), Q // 2, device="cuda", dtype=torch.int32)
    cases = []

    def judge(name, codes, inputs, gc_ids, lc, temperature, seed, same=True,
              first_step=0):
        rec = {"case": name, "ok": False}
        bad = smoke.code_range_fault(codes, Q)
        if bad is not None:
            rec["range"] = bad
        else:
            gap, first = score_gap(net, params, codes, inputs, gc_ids, lc,
                                   temperature, seed, first_step)
            rec.update(gap=gap, first_differing=first, repeat_equal=same,
                       ok=bool(np.isfinite(gap) and gap <= smoke.SCORE_TOL
                               and same))
        cases.append(rec)
        return rec["ok"]

    for batch, gc_ids, temperature in K1_CASES:
        seed = 11 + batch
        lc = smoke.seeded_lc(seed, batch, n_k1, 250)
        gen = CudaWaveNetGenerator(net, params, gc_ids=gc_ids)
        name = f"K1 B={batch} T={temperature:g}"
        warm = gen(n_k1, seed=seed, batch=batch, lc=lc, temperature=temperature)
        checked = gen(n_k1, seed=seed, batch=batch, lc=lc, temperature=temperature)
        torch.cuda.synchronize()
        for label, codes, other in (("warm", warm, None),
                                    ("checked", checked, warm)):
            same = True
            if other is not None and smoke.code_range_fault(other, Q) is None:
                same = torch.equal(codes, other)
            inputs = torch.cat([mid(batch), codes[:, :-1]], dim=1)
            judge(f"{name} {label}", codes, inputs, gc_ids, lc, temperature,
                  seed, same)

    # K3: a primed launch whose seed is an unprimed launch's own inputs
    seed, P = 42, prime_len
    lc = smoke.seeded_lc(seed, 1, P + n_primed, 250)
    gen = CudaWaveNetGenerator(net, params)
    free = gen(P + n_primed, seed=seed, batch=1, lc=lc, temperature=1.0)
    if judge("K1 B=1 T=1 (seed source)", free,
             torch.cat([mid(1), free[:, :-1]], dim=1), None, lc, 1.0, seed):
        seeds = torch.cat([mid(1), free[:, :P - 1]], dim=1).contiguous()
        codes = gen(n_primed, seed=seed, batch=1, seed_codes=seeds, lc=lc,
                    temperature=1.0)
        torch.cuda.synchronize()
        same = (smoke.code_range_fault(codes, Q) is None
                and torch.equal(codes, free[:, P - 1:P - 1 + n_primed]))
        judge("K3 B=1 T=1", codes, torch.cat([seeds, codes[:, :-1]], dim=1),
              None, lc, 1.0, seed, same, first_step=P - 1)

    # K4: carried launches of ``split`` from the fresh carry, vs one launch
    seed, n = 22, sum(split)
    lc = smoke.seeded_lc(seed, 1, n, 250)
    carry, parts, s = gen.chunk_carry0(1), [], 0
    for k in split:
        out, carry = gen.generate_chunk(carry, k, seed=seed, lc=lc[:, s:s + k],
                                        temperature=1.0)
        parts.append(out)
        s += k
    codes = torch.cat(parts, dim=1)
    one = gen(n, seed=seed, batch=1, lc=lc, temperature=1.0)
    torch.cuda.synchronize()
    same = (smoke.code_range_fault(one, Q) is None
            and smoke.code_range_fault(codes, Q) is None
            and torch.equal(codes, one))
    judge(f"K4 B=1 T=1 {'+'.join(map(str, split))}", codes,
          torch.cat([mid(1), codes[:, :-1]], dim=1), None, lc, 1.0, seed, same)
    return {"ok": all(c["ok"] for c in cases), "cases": cases}


def run(cmd, timeout=None) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)


def machine() -> dict:
    import torch

    def out(cmd):
        try:
            return run(cmd).stdout.strip()
        except OSError as exc:
            return f"unavailable: {exc}"

    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return {
        "card": out(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]),
        # which card: failures that follow one card, not the code, show here
        "gpu": out(["nvidia-smi", "--query-gpu=uuid,serial,pci.bus_id",
                    "--format=csv,noheader"]),
        "driver": out(["nvidia-smi", "--query-gpu=driver_version",
                       "--format=csv,noheader"]),
        "nvcc": out([nvcc, "--version"]).splitlines()[-1:],
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }


def save_smi(path: str) -> None:
    smi = run(["nvidia-smi", "-q", "-d",
               "ECC,PAGE_RETIREMENT,ROW_REMAPPER,PERFORMANCE,CLOCK"])
    with open(path, "w") as f:
        f.write(smi.stdout + smi.stderr)


def save_evidence(out_dir: str, index: int) -> None:
    save_smi(os.path.join(out_dir, f"fail-{index}-nvidia-smi.txt"))
    try:
        dm = run(["dmesg"], timeout=30)
        text = "".join(line + "\n" for line in dm.stdout.splitlines()
                       if "Xid" in line or "NVRM" in line)
        text += f"(dmesg rc {dm.returncode}: {dm.stderr.strip()[:200]})\n"
    except (OSError, subprocess.TimeoutExpired) as exc:
        text = f"dmesg unavailable: {exc}\n"
    with open(os.path.join(out_dir, f"fail-{index}-dmesg.txt"), "w") as f:
        f.write(text)


def child_cmd(n_k1, n_primed, prime_len, split) -> list:
    return [sys.executable, os.path.abspath(__file__), "--child",
            "--n", str(n_k1), "--n-primed", str(n_primed),
            "--prime-len", str(prime_len), "--split", ",".join(map(str, split))]


def sanitize(out_dir: str) -> dict:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(home, "bin", "compute-sanitizer")
    if not os.path.exists(tool):
        tool = shutil.which("compute-sanitizer")
    if tool is None:
        return {"available": False}
    short = child_cmd(SANITIZE_T, SANITIZE_T // 2, SANITIZE_T // 2,
                      (SANITIZE_T // 2, 1, SANITIZE_T // 2 - 1))
    results = {"available": True, "path": tool,
               "version": run([tool, "--version"]).stdout.strip().splitlines()[-1:]}
    for name in ("racecheck", "synccheck", "initcheck", "memcheck"):
        t0 = time.perf_counter()
        try:
            proc = run([tool, "--tool", name, "--print-limit", "20",
                        "--kernel-name", "kns=wavenet_sample", *short],
                       timeout=SANITIZE_TIMEOUT)
            text, rc = proc.stdout + proc.stderr, proc.returncode
        except subprocess.TimeoutExpired as exc:
            text, rc = f"timed out after {SANITIZE_TIMEOUT} s: {exc}", None
        with open(os.path.join(out_dir, f"sanitize-{name}.txt"), "w") as f:
            f.write(text)
        summary = [line for line in text.splitlines()
                   if "ERROR SUMMARY" in line or "RACECHECK SUMMARY" in line
                   or "not supported" in line.lower() or "error" in line.lower()]
        results[name] = {"rc": rc, "seconds": round(time.perf_counter() - t0, 1),
                         "summary": summary[:12]}
        print(f"compute-sanitizer --tool {name}: rc {rc}; "
              + " | ".join(summary[:4]), flush=True)
    return results


def main() -> int:
    import chip_smoke as smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "stress"))
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=smoke.N_CHECK)
    ap.add_argument("--n-primed", type=int, default=smoke.N_PRIMED)
    ap.add_argument("--prime-len", type=int, default=smoke.PRIME_LEN)
    ap.add_argument("--split", default=",".join(map(str, smoke.CARRY_SPLIT)))
    args = ap.parse_args()
    split = tuple(int(k) for k in args.split.split(","))
    if args.child:
        print(json.dumps(child(args.n, args.n_primed, args.prime_len, split)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the stress run needs the card", file=sys.stderr)
        return 1
    from nspeech_tpu_torch.ops.cuda import build

    os.makedirs(args.out, exist_ok=True)
    info = machine()
    save_smi(os.path.join(args.out, "start-nvidia-smi.txt"))   # the baseline
    print(info["card"], flush=True)
    t0 = time.perf_counter()
    build.build("wavenet_gen.cu")
    info["build_s"] = round(time.perf_counter() - t0, 1)
    procs, failed = [], 0
    cmd = child_cmd(args.n, args.n_primed, args.prime_len, split)
    for i in range(args.procs):
        t0 = time.perf_counter()
        proc = run(cmd)
        rec = {"index": i, "rc": proc.returncode,
               "seconds": round(time.perf_counter() - t0, 1)}
        try:
            rec.update(json.loads(proc.stdout.strip().splitlines()[-1]))
        except (IndexError, ValueError):
            rec["ok"] = False
            rec["stderr"] = proc.stderr[-2000:]
        if not rec["ok"]:
            failed += 1
            save_evidence(args.out, i)
            bad = [c for c in rec.get("cases", []) if not c["ok"]]
            print(f"process {i}: FAIL rc {proc.returncode} {bad[:1] or rec.get('stderr', '')[-400:]}",
                  flush=True)
        else:
            print(f"process {i}: ok in {rec['seconds']} s (largest gap "
                  f"{max(c['gap'] for c in rec['cases']):.3g})", flush=True)
        procs.append(rec)
    summary = {"procs": args.procs, "failed": failed, "machine": info,
               "n_check": args.n, "prime": [args.prime_len, args.n_primed],
               "split": split, "score_tol": smoke.SCORE_TOL}
    if args.sanitize:
        summary["sanitize"] = sanitize(args.out)
    with open(os.path.join(args.out, "stress.json"), "w") as f:
        json.dump({**summary, "processes": procs}, f, indent=1)
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
