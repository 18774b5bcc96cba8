"""setup_s: seconds from the process's start to the window's: imports,
CUDA start-up, the kernels and the native runtime loaded from the
program's build directory, the traffic made, the warm-up."""


def read(run):
    return run.setup_s
