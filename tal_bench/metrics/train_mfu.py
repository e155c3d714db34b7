"""Models: the configuration's FLOPs per training step (main and SSL
passes, forward and backward) for the steps completed, over the traced
window, over the card's TF32 peak, in %."""

from tal_bench import counting


def read(run):
    c = run.counters
    if run.kind != 'train':
        return None
    return counting.mfu_pct(c['steps'], c['flops_per_unit'],
                            run.trace.window_s, 'tf32')
