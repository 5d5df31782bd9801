"""k3_roofline (kernels: csrc/banded_align.cu banded_trace_packed_kernel,
K3): K3's least time on the card (roofline/k3.py k3_bound), counted on
the arguments that each chunk of the profiled map's pool file hands its
packed entry point (an eager map of that file after the window), over
K3's time in the profiled map's graph replays of the same chunks (every
instance in the trace), in percent.  K3 traces the single-end winners on
the card: the paired-end program has none, and there it reads nothing."""

RECORD = "banded_trace_packed"  # the entry point in map/pipeline.py
KERNEL = "banded_trace_packed_kernel"  # its kernel's name in the trace


def count(args):
    from abismal_bench.roofline.k3 import k3_bound

    return k3_bound(args)


def read(run):
    from abismal_bench.harness.trace import kernel_time
    from abismal_bench.roofline.kernels import share

    return share(run.recorded.get("k3_roofline"),
                 kernel_time(run.trace, KERNEL))
