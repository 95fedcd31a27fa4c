"""Set-up: from the process's start to the window's first due request
(the kernel library built or loaded, the weights made and converted, every
bucket the cell reaches captured, the server listening)."""


def read(run):
    return run.setup_s
