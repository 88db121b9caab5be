"""State carried across from the reference package.

This system has no weights; its state is arrays with distributions, and
launch descriptions.  This module turns the reference package's objects,
handed over as numpy arrays and plain Python values, into this package's,
without importing the reference: a ``Distribution`` or ``WorkDistribution``
instance is mapped to the class of the same name here by
``type(obj).__name__`` and its dataclass fields.  The parity tests build
every input with numpy from a seed and hand it to both sides through this
one door.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .core import distributions as _dists
from .core import superblock as _work
from .core.dist_array import DistributedArray
from .core.distributions import Distribution
from .core.superblock import WorkDistribution


def _same_named(obj: Any, module, base: type) -> Any:
    if isinstance(obj, base):  # already one of ours
        return obj
    name = type(obj).__name__
    cls = getattr(module, name, None)
    if not (isinstance(cls, type) and issubclass(cls, base)):
        raise TypeError(
            f"no {base.__name__} named {name!r} in {module.__name__}")
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"{name} is not a dataclass instance")
    # Field by field, not asdict(): asdict would recurse into nested
    # dataclasses and copy callables' containers.
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return cls(**fields)


def dist_from_reference(obj: Any) -> Distribution:
    """A reference ``Distribution`` as this package's class of that name.
    ``CustomDist`` carries its callables over as they are; they must
    return this package's ``Chunk``/``Region`` to be usable here."""
    return _same_named(obj, _dists, Distribution)


def work_from_reference(obj: Any) -> WorkDistribution:
    """A reference ``WorkDistribution`` as this package's class of that
    name."""
    return _same_named(obj, _work, WorkDistribution)


def array_from_reference(ctx, name: str, np_value: np.ndarray,
                         dist: Any = None) -> DistributedArray:
    """A reference array, handed over as ``np.asarray(arr.value)`` with its
    name and distribution, as a ``DistributedArray`` on ``ctx``'s device."""
    value = np.ascontiguousarray(np_value)
    return ctx.array(value, dist=None if dist is None
                     else dist_from_reference(dist), name=name)
