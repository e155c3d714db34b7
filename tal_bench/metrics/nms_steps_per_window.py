"""Post-processing: soft-NMS pick-loop iterations (the program's
`nms.steps` counter, counted inside the traced window) per window of
video completed."""

from tal_bench.metrics import _program


def read(run):
    windows = run.counters.get('windows')
    if run.kind != 'infer' or not windows:
        return None
    steps = _program.counted(run, 'nms.steps')
    return None if steps is None else steps / windows
