"""model_build_s.train: seconds of the model's build at a training cell's set-up (the
program's ``build`` span: static assets, parameters initialised on the host, the move to
the card), before the seed's weights are loaded."""
from benchmark.program_spans import build_s


def read(out, cell):
    return build_s(out)
