"""Seconds from the start of the run's process to the start of the
window: loading, placing the data, the warm-up and, in a checkout's first
run, the build of the program's kernels."""


def read(r):
    return r.setup_s
