"""loop_share (batch loop: run_map_pipelined, io/fastq.py, io/sam.py):
the share of the window's wall outside the harness's spans around the
engine's dispatch and finish calls, over the maps that were not
profiled."""


def read(run):
    sp = run.spans
    if sp is None or run.loop_wall_s <= 0:
        return None
    return 1.0 - (sp.total["dispatch"] + sp.total["finish"]) / run.loop_wall_s
