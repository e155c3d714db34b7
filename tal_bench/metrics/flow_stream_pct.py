"""Models: the card's time in the flow stream's forwards (the program's
`stream.flow_ms` counter, CUDA events around each flow model call,
counted inside the traced window) over the traced window, in %."""

from tal_bench.metrics import _program


def read(run):
    if run.kind != 'infer' or run.trace.window_s <= 0:
        return None
    ms = _program.counted(run, 'stream.flow_ms')
    return None if ms is None else 100.0 * ms / 1e3 / run.trace.window_s
