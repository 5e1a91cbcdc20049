"""setup_s: from the process's start to the first measured drain: CUDA
start, the kernels' build or load, the replay's population, the cold
window and the warm windows."""


def read(run):
    return run.setup_s
