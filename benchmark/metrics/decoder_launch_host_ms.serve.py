"""decoder_launch_host_ms.serve: host ms a batch of the untraced tail in the head's merge and
decoder spans: the launches the card waits on after the head's last sync."""
from benchmark.program_spans import phase_ms


def read(out, cell):
    return phase_ms(out, "merge", "decoder")
