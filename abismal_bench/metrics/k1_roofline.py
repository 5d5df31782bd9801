"""k1_roofline (kernels: csrc/popcount_compare.cu popcount_compare_kernel,
K1): K1's least time on the card (roofline/k1.py k1_bound), counted on
the arguments that each chunk of the profiled map's pool file hands it
(an eager map of that file after the window), over K1's time in the
profiled map's graph replays of the same chunks (every instance in the
trace), in percent.  In pe_g1000_l160 a unit holds 20 read words: K1
runs its second turn of 16 there."""

RECORD = "popcount_compare"  # the entry point in map/pipeline.py
KERNEL = "popcount_compare_kernel"  # its kernel's name in the trace


def count(args):
    from abismal_bench.roofline.k1 import k1_bound

    return k1_bound(*args)


def read(run):
    from abismal_bench.harness.trace import kernel_time
    from abismal_bench.roofline.kernels import share

    return share(run.recorded.get("k1_roofline"),
                 kernel_time(run.trace, KERNEL))
