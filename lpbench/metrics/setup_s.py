"""setup_s: the start of the process to the start of the window
(imports, CUDA's start, the kernels' build or load, the base instances
and the warm-up call)."""


def read(run):
    return run.setup_s
