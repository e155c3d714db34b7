"""Pipeline scheduling and ingest: the share of the traced window in
which the card is idle while the main thread is inside the program's
`ingest.*` spans (blocked on the prefetch queue for the next staged
flush), in %."""

from tal_bench.metrics import _program


def read(run):
    if run.kind != 'infer':
        return None
    return _program.idle_in_pct(run, ('ingest.',))
