"""Rectangular region algebra for Lightning's planner.

The paper's planner reasons entirely about dense, axis-aligned rectangles:
superblocks, chunks, and access regions are all n-d boxes.  This module is
the closed-form interval arithmetic that makes annotation evaluation exact.

Conventions
-----------
* A :class:`Region` is a tuple of half-open integer intervals
  ``[(start, stop), ...]`` — one per axis, ``start <= stop``.
* An :class:`Affine` expression is a linear combination of named variables
  with integer coefficients plus an integer constant.  The paper restricts
  annotation index expressions to exactly this class ("linear combination of
  the bound variables") so that access regions are computable in closed form.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Mapping, Sequence


# ---------------------------------------------------------------------------
# Affine expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Affine:
    """Integer-valued affine expression ``sum(coeff[v] * v) + const``."""

    coeffs: tuple[tuple[str, int], ...] = ()
    const: int = 0

    # -- constructors -------------------------------------------------------

    @staticmethod
    def constant(c: int) -> "Affine":
        return Affine((), int(c))

    @staticmethod
    def var(name: str, coeff: int = 1) -> "Affine":
        if coeff == 0:
            return Affine((), 0)
        return Affine(((name, int(coeff)),), 0)

    # -- algebra ------------------------------------------------------------

    def _as_dict(self) -> dict[str, int]:
        return dict(self.coeffs)

    @staticmethod
    def _from_dict(d: Mapping[str, int], const: int) -> "Affine":
        items = tuple(sorted((k, int(v)) for k, v in d.items() if v != 0))
        return Affine(items, int(const))

    def __add__(self, other: "Affine | int") -> "Affine":
        if isinstance(other, int):
            return Affine(self.coeffs, self.const + other)
        d = self._as_dict()
        for k, v in other.coeffs:
            d[k] = d.get(k, 0) + v
        return Affine._from_dict(d, self.const + other.const)

    def __sub__(self, other: "Affine | int") -> "Affine":
        if isinstance(other, int):
            return Affine(self.coeffs, self.const - other)
        return self + other.scale(-1)

    def scale(self, k: int) -> "Affine":
        return Affine._from_dict({v: c * k for v, c in self.coeffs}, self.const * k)

    # -- analysis ------------------------------------------------------------

    @property
    def is_constant(self) -> bool:
        return not self.coeffs

    def variables(self) -> tuple[str, ...]:
        return tuple(v for v, _ in self.coeffs)

    def evaluate(self, env: Mapping[str, int]) -> int:
        return self.const + sum(c * env[v] for v, c in self.coeffs)

    def bounds(self, env: Mapping[str, tuple[int, int]]) -> tuple[int, int]:
        """Min/max over a box of variable ranges (half-open ``[lo, hi)``).

        Exact for affine expressions: extrema are attained at interval
        endpoints, chosen per-variable by coefficient sign.
        """
        lo = hi = self.const
        for v, c in self.coeffs:
            vlo, vhi = env[v]
            if vhi <= vlo:
                raise ValueError(f"empty range for variable {v!r}: [{vlo}, {vhi})")
            if c >= 0:
                lo += c * vlo
                hi += c * (vhi - 1)
            else:
                lo += c * (vhi - 1)
                hi += c * vlo
        return lo, hi

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [f"{c}*{v}" if c != 1 else v for v, c in self.coeffs]
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts).replace("+ -", "- ")


# ---------------------------------------------------------------------------
# Regions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Region:
    """Axis-aligned n-d box of half-open integer intervals."""

    intervals: tuple[tuple[int, int], ...]

    def __post_init__(self) -> None:
        for lo, hi in self.intervals:
            if hi < lo:
                raise ValueError(f"malformed interval [{lo}, {hi})")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_shape(shape: Sequence[int]) -> "Region":
        return Region(tuple((0, int(s)) for s in shape))

    @staticmethod
    def empty(ndim: int) -> "Region":
        return Region(tuple((0, 0) for _ in range(ndim)))

    @staticmethod
    def of(*intervals: tuple[int, int]) -> "Region":
        return Region(tuple((int(a), int(b)) for a, b in intervals))

    # -- basic properties ----------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.intervals)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.intervals)

    @property
    def starts(self) -> tuple[int, ...]:
        return tuple(lo for lo, _ in self.intervals)

    @property
    def is_empty(self) -> bool:
        return any(hi <= lo for lo, hi in self.intervals)

    @property
    def volume(self) -> int:
        return math.prod(self.shape) if not self.is_empty else 0

    # -- algebra -------------------------------------------------------------

    def intersect(self, other: "Region") -> "Region":
        self._check_ndim(other)
        ivals = []
        for (a0, a1), (b0, b1) in zip(self.intervals, other.intervals):
            lo, hi = max(a0, b0), min(a1, b1)
            ivals.append((lo, max(lo, hi)))
        return Region(tuple(ivals))

    def overlaps(self, other: "Region") -> bool:
        return not self.intersect(other).is_empty

    def contains(self, other: "Region") -> bool:
        """True iff ``other`` (possibly empty) lies fully inside ``self``."""
        self._check_ndim(other)
        if other.is_empty:
            return True
        return all(
            a0 <= b0 and b1 <= a1
            for (a0, a1), (b0, b1) in zip(self.intervals, other.intervals)
        )

    def contains_point(self, point: Sequence[int]) -> bool:
        return all(lo <= p < hi for p, (lo, hi) in zip(point, self.intervals))

    def shift(self, offsets: Sequence[int]) -> "Region":
        return Region(
            tuple((lo + d, hi + d) for (lo, hi), d in zip(self.intervals, offsets))
        )

    def clip(self, bounds: "Region") -> "Region":
        return self.intersect(bounds)

    def expand(self, halo: Sequence[int] | int) -> "Region":
        """Grow by ``halo`` cells on each side per axis (stencil borders)."""
        if isinstance(halo, int):
            halo = [halo] * self.ndim
        return Region(
            tuple((lo - h, hi + h) for (lo, hi), h in zip(self.intervals, halo))
        )

    def hull(self, other: "Region") -> "Region":
        """Smallest region containing both (bounding box of the union)."""
        self._check_ndim(other)
        if self.is_empty:
            return other
        if other.is_empty:
            return self
        return Region(
            tuple(
                (min(a0, b0), max(a1, b1))
                for (a0, a1), (b0, b1) in zip(self.intervals, other.intervals)
            )
        )

    def relative_to(self, origin: "Region") -> "Region":
        """Translate into the local coordinate frame of ``origin``.

        This is the paper's wrapper-kernel offset rebase: global array
        indices minus the chunk's offset.
        """
        return self.shift([-lo for lo in origin.starts])

    def to_slices(self) -> tuple[slice, ...]:
        return tuple(slice(lo, hi) for lo, hi in self.intervals)

    def _check_ndim(self, other: "Region") -> None:
        if self.ndim != other.ndim:
            raise ValueError(f"rank mismatch: {self.ndim} vs {other.ndim}")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "Region[" + ", ".join(f"{lo}:{hi}" for lo, hi in self.intervals) + "]"


# ---------------------------------------------------------------------------
# Grid decomposition helpers
# ---------------------------------------------------------------------------


def split_extent(extent: int, parts: int) -> list[tuple[int, int]]:
    """Split ``[0, extent)`` into ``parts`` contiguous near-equal intervals."""
    if parts <= 0:
        raise ValueError("parts must be positive")
    base, rem = divmod(extent, parts)
    out, pos = [], 0
    for i in range(parts):
        size = base + (1 if i < rem else 0)
        out.append((pos, pos + size))
        pos += size
    return out


def tile_region(domain: Region, tile_shape: Sequence[int]) -> list[Region]:
    """Cover ``domain`` with axis-aligned tiles of ``tile_shape`` (edge tiles
    are clipped).  Tiles are emitted in row-major order of their grid index.
    """
    if len(tile_shape) != domain.ndim:
        raise ValueError("tile rank mismatch")
    axes: list[list[tuple[int, int]]] = []
    for (lo, hi), t in zip(domain.intervals, tile_shape):
        t = max(1, int(t))
        axes.append([(s, min(s + t, hi)) for s in range(lo, hi, t)] or [(lo, hi)])
    return [Region(tuple(combo)) for combo in itertools.product(*axes)]


def cover_exactly(domain: Region, parts: Iterable[Region]) -> bool:
    """True iff ``parts`` are pairwise disjoint and exactly tile ``domain``.

    Used by property tests: superblock decompositions must satisfy this
    (chunk distributions need only *cover*, they may overlap).
    """
    parts = [p for p in parts if not p.is_empty]
    total = sum(p.volume for p in parts)
    if total != domain.volume:
        return False
    for i, a in enumerate(parts):
        if not domain.contains(a):
            return False
        for b in parts[i + 1 :]:
            if a.overlaps(b):
                return False
    return True


def covers(domain: Region, parts: Iterable[Region]) -> bool:
    """True iff the union of ``parts`` includes every cell of ``domain``.

    Exact sweep: subdivide the domain along the distinct axis cuts induced by
    the parts; each elementary cell must be inside at least one part.
    """
    parts = [p.intersect(domain) for p in parts]
    parts = [p for p in parts if not p.is_empty]
    if domain.is_empty:
        return True
    cuts: list[list[int]] = []
    for ax, (lo, hi) in enumerate(domain.intervals):
        pts = {lo, hi}
        for p in parts:
            plo, phi = p.intervals[ax]
            pts.add(min(max(plo, lo), hi))
            pts.add(min(max(phi, lo), hi))
        cuts.append(sorted(pts))
    for combo in itertools.product(*(range(len(c) - 1) for c in cuts)):
        cell = Region(
            tuple((cuts[ax][i], cuts[ax][i + 1]) for ax, i in enumerate(combo))
        )
        if cell.is_empty:
            continue
        if not any(p.contains(cell) for p in parts):
            return False
    return True
