"""device_fallback_frac (device program): the share of the units sent to
the device that it handed back to the host, n_fallback / n_units of the
engine over the warm-up and the window."""


def read(run):
    c = run.counters
    return c["n_fallback"] / c["n_units"] if c.get("n_units") else None
