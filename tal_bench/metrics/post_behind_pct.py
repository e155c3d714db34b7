"""Pipeline scheduling: the windows whose video was post-processed while
a later flush's forwards were under way on the card (the program's
`post.behind` counter, counted inside the traced window), over the
windows of every video offered, in %."""

from tal_bench.metrics import _program


def read(run):
    windows = run.counters.get('windows')
    if run.kind != 'infer' or not windows:
        return None
    behind = _program.counted(run, 'post.behind')
    return None if behind is None else 100.0 * behind / windows
