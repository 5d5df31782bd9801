"""replay_ms (device program: a graphs.py replay of build_stage12 or
build_stage12pe): from the first to the last device operation of each
replay in the profiled map, grouped by the cudaGraphLaunch that started
it, the mean over the replays."""


def read(run):
    t = run.trace
    return None if t is None else t["replay_ms"]
