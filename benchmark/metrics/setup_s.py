"""Set-up: from the process's start (imports, weights, warm-up, the
kernels' build on a first run) to the window's start, host clock."""


def read(run, ctx):
    return run.info["setup_s"]
