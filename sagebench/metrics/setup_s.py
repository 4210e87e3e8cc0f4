"""From the process's start to the window's (host clock): loading,
building the kernels where they are not built yet, weights, warm-up."""


def read(rec):
    return rec.setup_s
