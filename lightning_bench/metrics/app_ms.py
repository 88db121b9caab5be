"""The window's seconds over the applications it completed, in ms."""


def read(r):
    return 1e3 * r.window_s / len(r.apps) if r.apps else None
