"""train.step, losses and optimizer: the share of the traced window in
which the card is idle while the main thread is inside the program's
`step.loss` spans (the training objective of the step's outputs), in
%."""

from tal_bench.metrics import _program


def read(run):
    if run.kind != 'train':
        return None
    return _program.idle_in_pct(run, ('step.loss',))
