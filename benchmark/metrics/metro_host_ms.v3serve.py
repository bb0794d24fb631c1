"""metro_host_ms.v3serve: host ms a batch of the untraced tail in the program's
``metro`` span: the launches of the METRO stage's 12 layers."""
from benchmark.program_spans import phase_ms


def read(out, cell):
    return phase_ms(out, "metro")
