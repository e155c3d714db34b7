"""Pipeline scheduling: real windows over rows forwarded, in % (the rows
counted by the benchmark's forward pre-hook on the model it built)."""


def read(run):
    c = run.counters
    if run.kind != 'infer' or not c.get('rows'):
        return None
    return 100.0 * c['windows'] / c['rows']
