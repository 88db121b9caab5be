"""The 95th percentile (nearest rank) of every application's seconds in
the window, in ms."""

import math


def read(r):
    if not r.apps:
        return None
    ranked = sorted(r.apps)
    return 1e3 * ranked[math.ceil(0.95 * len(ranked)) - 1]
