"""setup_s (end to end, host clock): the process's start to the window's
start: imports, CUDA init, the index file's read, the table upload, the
pool's simulation and FASTQ files, and one warm-up map of one pool file,
which captures every graph the window replays.  In a checkout's first
run, also the genome, its index and the kernels' build."""


def read(run):
    return run.setup_s
