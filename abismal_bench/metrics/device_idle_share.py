"""device_idle_share (the device): 1 - the union of the device
operations' intervals over the profiled map's wall, from torch.profiler's
trace."""


def read(run):
    t = run.trace
    if t is None or not t["window_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
