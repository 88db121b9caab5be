"""Chunk distributions for Lightning's distributed arrays (paper §2.2).

A *distribution policy* maps an array's index domain to a set of rectangular
*chunks*, each owned by one device.  Chunks may overlap (stencil halos,
replication); superblock distributions (``superblock.py``) may not.

Two consumers:

* the **planner** queries ``chunks()`` / ``find_enclosing()`` to decide which
  data movement a launch needs (the paper's Copy/Send/Recv insertion);
* the **launcher** calls ``partition_spec()`` to express the same
  placement as a plain tuple of named mesh axes (one entry per array axis),
  plus halo metadata for overlapping distributions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from .ndrange import Region, split_extent, tile_region


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One rectangular piece of an array, owned by one device."""

    index: int  # dense chunk id within the distribution
    region: Region  # global coordinates covered (incl. halo for stencil)
    owner: int  # flat device index
    interior: Region | None = None  # owned (non-halo) sub-region, if different

    @property
    def nbytes_per_elem_region(self) -> int:
        return self.region.volume


class Distribution:
    """Base class: a chunking policy over a fixed array shape + device count."""

    #: mesh axes this distribution shards over, per array axis (None = replicated
    #: along that axis).  Used by the launcher. Subclasses override.
    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        raise NotImplementedError

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        raise NotImplementedError

    # -- queries used by the planner -----------------------------------------

    def query(
        self, region: Region, shape: Sequence[int], num_devices: int
    ) -> list[Chunk]:
        """All chunks intersecting ``region``."""
        return [
            c
            for c in self.chunks(shape, num_devices)
            if c.region.overlaps(region)
        ]

    def find_enclosing(
        self, region: Region, shape: Sequence[int], num_devices: int
    ) -> Chunk | None:
        """The common case (paper §2.4): a single chunk encloses the region."""
        best: Chunk | None = None
        for c in self.chunks(shape, num_devices):
            if c.region.contains(region):
                if best is None or c.region.volume < best.region.volume:
                    best = c
        return best

    # -- metadata -------------------------------------------------------------

    @property
    def halo(self) -> tuple[int, ...] | None:
        """Per-axis halo width for overlapping (stencil) distributions."""
        return None

    @property
    def replicated(self) -> bool:
        return False


# ---------------------------------------------------------------------------
# Concrete policies (the paper ships row/column-wise, tiled, stencil, custom)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicatedDist(Distribution):
    """Every device holds the full array (paper: replicated small data)."""

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        full = Region.from_shape(shape)
        return [Chunk(d, full, d) for d in range(num_devices)]

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        return ()  # fully replicated

    @property
    def replicated(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class BlockDist(Distribution):
    """Contiguous 1-D blocks of ``chunk_size`` elements along ``axis``,
    assigned round-robin over devices (the paper's default for vectors)."""

    chunk_size: int
    axis: int = 0

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        full = Region.from_shape(shape)
        extent = shape[self.axis]
        out: list[Chunk] = []
        n = max(1, math.ceil(extent / self.chunk_size))
        for i in range(n):
            lo = i * self.chunk_size
            hi = min(extent, lo + self.chunk_size)
            ivals = list(full.intervals)
            ivals[self.axis] = (lo, hi)
            out.append(Chunk(i, Region(tuple(ivals)), i % num_devices))
        return out

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        spec: list[str | None] = [None] * max(1, self.axis + 1)
        spec[self.axis] = mesh_axes[0]
        return tuple(spec)


@dataclasses.dataclass(frozen=True)
class RowDist(Distribution):
    """Partition axis 0 into ``num_chunks`` near-equal contiguous chunks
    (defaults to one per device) — paper Fig. 2b."""

    num_chunks: int | None = None

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        n = self.num_chunks or num_devices
        full = Region.from_shape(shape)
        out = []
        for i, (lo, hi) in enumerate(split_extent(shape[0], n)):
            ivals = list(full.intervals)
            ivals[0] = (lo, hi)
            out.append(Chunk(i, Region(tuple(ivals)), i % num_devices))
        return out

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        return (mesh_axes[0],)


@dataclasses.dataclass(frozen=True)
class ColDist(Distribution):
    """Partition axis 1 (columns) — paper Fig. 2c."""

    num_chunks: int | None = None

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        if len(shape) < 2:
            raise ValueError("ColDist requires rank >= 2")
        n = self.num_chunks or num_devices
        full = Region.from_shape(shape)
        out = []
        for i, (lo, hi) in enumerate(split_extent(shape[1], n)):
            ivals = list(full.intervals)
            ivals[1] = (lo, hi)
            out.append(Chunk(i, Region(tuple(ivals)), i % num_devices))
        return out

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        return (None, mesh_axes[0])


@dataclasses.dataclass(frozen=True)
class TileDist(Distribution):
    """Rectangular tiles of ``tile_shape`` — paper Fig. 2a."""

    tile_shape: tuple[int, ...]

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        tiles = tile_region(Region.from_shape(shape), self.tile_shape)
        return [Chunk(i, t, i % num_devices) for i, t in enumerate(tiles)]

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        # 2-D tiling over the first two mesh axes.
        n = len(self.tile_shape)
        return tuple(mesh_axes[i] if i < len(mesh_axes) else None for i in range(n))


@dataclasses.dataclass(frozen=True)
class StencilDist(Distribution):
    """Block distribution with an overlapping halo border per chunk.

    This is the paper's canonical *overlapping* distribution: each chunk owns
    an interior block and additionally replicates ``halo`` cells of its
    neighbours.  The runtime keeps the replicas coherent — across several
    workers this becomes a neighbour halo exchange per iteration.
    """

    chunk_size: int
    halo_width: int = 1
    axis: int = 0

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        full = Region.from_shape(shape)
        extent = shape[self.axis]
        out: list[Chunk] = []
        n = max(1, math.ceil(extent / self.chunk_size))
        for i in range(n):
            lo = i * self.chunk_size
            hi = min(extent, lo + self.chunk_size)
            interior = list(full.intervals)
            interior[self.axis] = (lo, hi)
            outer = list(full.intervals)
            outer[self.axis] = (max(0, lo - self.halo_width),
                                min(extent, hi + self.halo_width))
            out.append(
                Chunk(
                    i,
                    Region(tuple(outer)),
                    i % num_devices,
                    interior=Region(tuple(interior)),
                )
            )
        return out

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        spec: list[str | None] = [None] * max(1, self.axis + 1)
        spec[self.axis] = mesh_axes[0]
        return tuple(spec)

    @property
    def halo(self) -> tuple[int, ...]:
        h = [0] * max(1, self.axis + 1)
        h[self.axis] = self.halo_width
        return tuple(h)


@dataclasses.dataclass(frozen=True)
class CustomDist(Distribution):
    """User-supplied chunking function (paper: "custom distributions")."""

    fn: Callable[[Sequence[int], int], list[Chunk]]
    spec_fn: Callable[[Sequence[str]], tuple[str | None, ...]] | None = None

    def chunks(self, shape: Sequence[int], num_devices: int) -> list[Chunk]:
        return self.fn(shape, num_devices)

    def partition_spec(self, mesh_axes: Sequence[str]) -> tuple[str | None, ...]:
        if self.spec_fn is None:
            raise NotImplementedError("CustomDist without spec_fn")
        return self.spec_fn(mesh_axes)
