"""launches_per_request.rig: device kernels, copies and sets a request, from the profile."""
from benchmark.readers import launches_per_step


def read(out, cell):
    return launches_per_step(out)
