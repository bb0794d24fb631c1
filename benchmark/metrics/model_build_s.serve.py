"""model_build_s.serve: seconds of the model's build at set-up (the program's ``build``
span: static assets, parameters initialised on the host, the move to the card)."""
from benchmark.program_spans import build_s


def read(out, cell):
    return build_s(out)
