"""finish_ms (finalize: TorchNativeEngine.finish_se/pe, then the native
engine's collect, stage 2, fallback re-map and SAM text): host
milliseconds a call, the mean over the maps that were not profiled."""


def read(run):
    sp = run.spans
    if sp is None or not sp.calls["finish"]:
        return None
    return 1e3 * sp.total["finish"] / sp.calls["finish"]
