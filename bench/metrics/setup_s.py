"""setup_s: seconds from the process's start to the window's first timed
operation: imports, weights from the seed, the program's kernels built or
loaded, the cell's warm-up (and, for training, its first checked steps)."""


def read(run):
    return run["setup_s"]
