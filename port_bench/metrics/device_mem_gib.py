"""The card's reserved memory at most (``torch.cuda.max_memory_reserved``),
graph pools included, from the pipeline holding its weights (the
benchmark's own copies freed, the peak reset) through set-up and the
window, read before the reference runs: what one resident mode costs."""


def read(run):
    return run.memory_reserved_peak / 2**30 if run.memory_reserved_peak else None
