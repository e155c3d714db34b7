"""Post-processing and pipeline: CUDA kernel launches in the traced
window per window of video completed."""


def read(run):
    c = run.counters
    if run.kind != 'infer' or not c.get('windows'):
        return None
    return run.trace.launches / c['windows']
