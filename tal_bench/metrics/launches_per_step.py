"""train.step, losses and optimizer: CUDA kernel launches in the traced
window per training step."""


def read(run):
    c = run.counters
    if run.kind != 'train' or not c.get('steps'):
        return None
    return run.trace.launches / c['steps']
