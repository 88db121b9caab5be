"""Helpers shared by the ``test_torch_*`` parity tests.

The reference package (``repro``, JAX) and the port (``repro_torch``,
PyTorch) share no classes, so objects are compared through ``plain()``: a
recursive rendering into tuples, dicts and scalars keyed by class *name*.
Inputs are made with numpy from a seed and handed to each side as numpy.
"""

import dataclasses
import enum

import numpy as np


def plain(obj):
    """Class-name-keyed plain rendering of planner/annotation objects."""
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        return ("dict", tuple(sorted((plain(k), plain(v))
                                     for k, v in obj.items())))
    if isinstance(obj, (list, tuple)):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, (str, int, float, bool, type(None))):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"plain(): unhandled {type(obj)!r}")


def task_rows(plan):
    """One tuple per task: kind, worker, deps, bytes and the rest of the
    payload, for a task-by-task comparison."""
    return [plain(t) for t in plan.tasks]


def launch_plan_rows(lp):
    return {
        "name": lp.name,
        "grid": tuple(lp.grid),
        "num_superblocks": lp.num_superblocks,
        "args": [plain(a) for a in lp.args],
        "tasks": task_rows(lp.plan),
    }
