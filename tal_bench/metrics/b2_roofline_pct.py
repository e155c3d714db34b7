"""Kernels: each captured `opental::boundary_max_pool_bwd` call's least
time (its bytes over the card's memory rate) over the device time of
the kernel it launched, summed over the calls, in %."""

from tal_bench import counting, trace


def read(run):
    calls = run.counters.get('calls')
    if run.kind != 'train' or calls is None:
        return None
    return counting.pool_roofline_pct(
        calls.bwd, run.trace.kernel_durations(trace.POOL_BWD_KERNEL),
        backward=True)
