"""k4_roofline (kernels: csrc/seed_extend.cu seed_extend_kernel, K4): K4's
least time on the card, the traffic its live lanes need
(roofline/kernels.py k4_bound), counted on the arguments that each chunk
of the profiled map's pool file hands it (an eager map of that file after
the window), over K4's time in the profiled map's graph replays of the
same chunks (every instance in the trace), in percent."""

RECORD = "seed_extend"  # the entry point in map/pipeline.py
KERNEL = "seed_extend_kernel"  # its kernel's name in the trace


def count(args):
    from abismal_bench.roofline.kernels import k4_bound

    return k4_bound(args)


def read(run):
    from abismal_bench.harness.trace import kernel_time
    from abismal_bench.roofline.kernels import share

    return share(run.recorded.get("k4_roofline"),
                 kernel_time(run.trace, KERNEL))
