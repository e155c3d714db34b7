"""Models: the configuration's forward FLOPs for the windows completed,
over the traced window, over the card's bf16 peak, in %."""

from tal_bench import counting


def read(run):
    c = run.counters
    if run.kind != 'infer':
        return None
    return counting.mfu_pct(c['windows'], c['flops_per_unit'],
                            run.trace.window_s, 'bf16')
