"""WaveNet train step (train/loop.py build_wavenet_train_step): kernel
launches in the device trace per traced step (the batch's copy to the
card, the step, the loss read)."""


def read(run, ctx):
    tr = run.info["traced"]
    if run.trace is None or not tr.get("steps"):
        return None
    return run.trace["launches"] / tr["steps"]
