"""Kernels: the device milliseconds, inside the traced window, of the
kernels whose name holds `max_pool3d` (the I3D's 3D max pools: PyTorch's
`max_pool3d_with_indices` kernels, or the port's own
`max_pool3d_same_kernel` where it has one, the same work whatever
implements it), per window of video completed in the window."""

NEEDLE = 'max_pool3d'


def read(run):
    c = run.counters
    if run.kind != 'infer' or not c.get('windows'):
        return None
    w0, w1 = run.trace.window_ns
    ns = sum(d for n, s, d in run.trace.all_device
             if NEEDLE in n and w0 <= s < w1)
    return ns / 1e6 / c['windows']
