"""k2_roofline (kernels: csrc/banded_align.cu banded_score_packed_kernel,
K2): K2's least time on the card (roofline/kernels.py k2_bound), counted
on the arguments that each chunk of the profiled map's pool file hands it
(an eager map of that file after the window), over K2's time in the
profiled map's graph replays of the same chunks (every instance in the
trace), in percent."""

RECORD = "banded_score_packed"  # the entry point in map/pipeline.py
KERNEL = "banded_score_packed_kernel"  # its kernel's name in the trace


def count(args):
    from abismal_bench.roofline.kernels import k2_bound

    return k2_bound(args)


def read(run):
    from abismal_bench.harness.trace import kernel_time
    from abismal_bench.roofline.kernels import share

    return share(run.recorded.get("k2_roofline"),
                 kernel_time(run.trace, KERNEL))
