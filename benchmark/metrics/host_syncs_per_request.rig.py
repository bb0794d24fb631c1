"""host_syncs_per_request.rig: the program's host syncs a request of the window's untraced
tail (its ``host_syncs`` counter, read from each request root)."""
from benchmark.program_spans import count_per_request


def read(out, cell):
    return count_per_request(out, "host_syncs")
