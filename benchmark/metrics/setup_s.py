"""setup_s: seconds from the start of the process to the window's start
(imports, the kernels' build or load, weights, inputs, the checked first
steps and the warm-up)."""


def read(run):
    return run.setup_s
