"""Superblock decomposition of distributed kernel launches (paper §2.1).

A kernel launch initiates an n-d grid of threads grouped into thread blocks.
Lightning exploits thread-block independence by grouping blocks into
rectangular, **disjoint** subgrids called *superblocks*; each superblock is
one job assigned to one device.

On one GPU a superblock is the whole launch grid; across several workers
it is the part of the grid one worker executes.  The decomposition below is
the device-placement math shared by the planner and the launcher.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .ndrange import Region, cover_exactly, split_extent


@dataclasses.dataclass(frozen=True)
class Superblock:
    """A disjoint rectangular subgrid of *threads*, owned by one device."""

    index: int
    threads: Region  # global thread coordinates
    owner: int  # flat device index

    def block_range(self, block_shape: Sequence[int]) -> Region:
        """Thread-block indices covered by this superblock."""
        ivals = []
        for (lo, hi), bs in zip(self.threads.intervals, block_shape):
            bs = int(bs)
            ivals.append((lo // bs, (hi - 1) // bs + 1 if hi > lo else lo // bs))
        return Region(tuple(ivals))


class WorkDistribution:
    """Policy: launch grid → superblocks (must tile the grid disjointly)."""

    def superblocks(
        self, grid: Sequence[int], num_devices: int
    ) -> list[Superblock]:
        raise NotImplementedError

    def validate(self, grid: Sequence[int], num_devices: int) -> None:
        sbs = self.superblocks(grid, num_devices)
        domain = Region.from_shape(grid)
        if not cover_exactly(domain, [s.threads for s in sbs]):
            raise ValueError(
                f"{type(self).__name__}: superblocks must disjointly tile the "
                f"launch grid {tuple(grid)}"
            )


@dataclasses.dataclass(frozen=True)
class BlockWork(WorkDistribution):
    """Fixed-size contiguous superblocks along ``axis``, round-robin owners.

    Mirrors the paper's ``BlockDist::new(64_000, devices)`` host-code idiom.
    """

    superblock_size: int
    axis: int = 0

    def superblocks(
        self, grid: Sequence[int], num_devices: int
    ) -> list[Superblock]:
        full = Region.from_shape(grid)
        extent = int(grid[self.axis])
        n = max(1, math.ceil(extent / self.superblock_size))
        out: list[Superblock] = []
        for i in range(n):
            lo = i * self.superblock_size
            hi = min(extent, lo + self.superblock_size)
            ivals = list(full.intervals)
            ivals[self.axis] = (lo, hi)
            out.append(Superblock(i, Region(tuple(ivals)), i % num_devices))
        return out


@dataclasses.dataclass(frozen=True)
class EvenWork(WorkDistribution):
    """One near-equal contiguous superblock per device along ``axis``."""

    axis: int = 0

    def superblocks(
        self, grid: Sequence[int], num_devices: int
    ) -> list[Superblock]:
        full = Region.from_shape(grid)
        out = []
        for i, (lo, hi) in enumerate(split_extent(int(grid[self.axis]), num_devices)):
            ivals = list(full.intervals)
            ivals[self.axis] = (lo, hi)
            out.append(Superblock(i, Region(tuple(ivals)), i))
        return out


@dataclasses.dataclass(frozen=True)
class TileWork(WorkDistribution):
    """2-D (or n-d) rectangular superblocks of ``tile_shape`` threads."""

    tile_shape: tuple[int, ...]

    def superblocks(
        self, grid: Sequence[int], num_devices: int
    ) -> list[Superblock]:
        from .ndrange import tile_region

        tiles = tile_region(Region.from_shape(grid), self.tile_shape)
        return [Superblock(i, t, i % num_devices) for i, t in enumerate(tiles)]


@dataclasses.dataclass(frozen=True)
class MeshWork(WorkDistribution):
    """Superblocks that mirror a named-mesh factorization of the grid.

    ``axis_map`` maps grid axes → number of ways to split (the mesh axis
    size): splitting grid axis *a* ``k`` ways corresponds to sharding that
    dimension over a mesh axis of ``k`` workers.
    """

    axis_splits: tuple[int, ...]  # one entry per grid axis (1 = unsplit)

    def superblocks(
        self, grid: Sequence[int], num_devices: int
    ) -> list[Superblock]:
        if len(self.axis_splits) != len(grid):
            raise ValueError("axis_splits rank must match grid rank")
        total = math.prod(self.axis_splits)
        if total != num_devices:
            raise ValueError(
                f"splits {self.axis_splits} produce {total} superblocks for "
                f"{num_devices} devices"
            )
        per_axis = [
            split_extent(int(g), int(k)) for g, k in zip(grid, self.axis_splits)
        ]
        out: list[Superblock] = []
        import itertools

        for idx, combo in enumerate(itertools.product(*per_axis)):
            out.append(Superblock(idx, Region(tuple(combo)), idx))
        return out
