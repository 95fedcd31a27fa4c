"""Mean rows a worker call served in the window (1 solo, up to the pool's
``max_batch`` coalesced)."""


def read(run):
    return sum(c["rows"] for c in run.calls) / len(run.calls) if run.calls else None
