"""dispatch_ms (engine dispatch: TorchNativeEngine.dispatch_se/pe, unit
encoding, the copy in, the replay's launch): host milliseconds a call,
the mean over the maps that were not profiled."""


def read(run):
    sp = run.spans
    if sp is None or not sp.calls["dispatch"]:
        return None
    return 1e3 * sp.total["dispatch"] / sp.calls["dispatch"]
