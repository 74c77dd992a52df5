"""Seconds of unpadded target audio (each row's real frames x 12.5 ms)
trained per wall second, over every step of the window: from the
window's start to the end of its last step (each step ends with the
loss read on the host)."""


def read(run, ctx):
    if not run.records or run.window_s <= 0:
        return None
    frames = sum(sum(r["frames"]) for r in run.records)
    return frames * run.info["frame_s"] / run.window_s
