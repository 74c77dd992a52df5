"""WaveNet train step (train/loop.py build_wavenet_train_step over
CudaGraphSteps): percent of the traced steps that replayed a CUDA graph
captured at an earlier step, from the program's train.replay spans whose
``captured`` is false (the step that captures a graph records the span
with ``captured`` true and is not counted). A traced window of eager or
capturing steps reads 0, and so does a program whose vocoder step has no
graph. None where the span recorder did not run (no device trace), the
program has none, or it dropped records (a part of the window would read
as the whole)."""


def read(run, ctx):
    from nspeech_tpu_torch.utils import profiling
    get = getattr(profiling, "spans", None)
    steps = run.info.get("traced", {}).get("steps")
    if run.trace is None or get is None or profiling.dropped() or not steps:
        return None
    replays = [r for r in get("train.replay") if not r.attrs.get("captured")]
    return 100.0 * len(replays) / steps
