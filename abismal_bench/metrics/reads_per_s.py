"""reads_per_s (end to end, host clock): every read of every map that
finished in the window (each mate of a pair counts), over the window's
seconds, from the first map's start to the last map's end."""


def read(run):
    return run.reads / run.window_s if run.window_s > 0 else None
