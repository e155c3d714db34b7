"""train.step, losses and optimizer (its datasets): the share of the
traced window in which the card is idle while the main thread is inside
the program's `loader.*` spans (blocked on the prefetch queue for the
next batch), in %."""

from tal_bench.metrics import _program


def read(run):
    if run.kind != 'train':
        return None
    return _program.idle_in_pct(run, ('loader.',))
