"""Lightning's data-annotation DSL.

The paper (§2.3) attaches a symbolic access-pattern annotation to every
kernel, e.g.::

    global i => read A[i-1:i+1], write B[i]
    global [i, j] => read A[i,:], read B[:,j], write C[i,j]
    global [i, j] => read A[i,j], reduce(+) sum[i]

Left of ``=>`` are *variable bindings* — ``global`` (global thread index),
``block`` (thread-block index), ``local`` (index within a block).  Right of
``=>`` are per-array access statements.  Index expressions must be linear in
the bound variables; slices use Fortran-style **inclusive** bounds and either
bound may be omitted (meaning the array extent).

Given the thread-index ranges of a superblock, :meth:`AccessStmt.region`
evaluates to the exact dense rectangular *access region* for that array —
the quantity the planner feeds into chunk intersection.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Sequence

from .ndrange import Affine, Region

# Access modes (paper §2.3).
READ = "read"
WRITE = "write"
READWRITE = "readwrite"
REDUCE = "reduce"

_MODES = (READ, WRITE, READWRITE, REDUCE)
_REDUCE_OPS = ("+", "*", "min", "max")
_SPACES = ("global", "block", "local")

_NAME_RE = re.compile(r"^[A-Za-z_]\w*$")


class AnnotationError(ValueError):
    """Raised for malformed annotation strings."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Binding:
    """One variable binding, e.g. ``global [i, j]`` binds i→axis0, j→axis1."""

    space: str  # 'global' | 'block' | 'local'
    names: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class IndexExpr:
    """One subscript: a point ``expr`` or an inclusive slice ``lo:hi``.

    ``lower``/``upper`` of ``None`` mean "unbounded" (clipped to the array
    extent).  A point has ``is_point=True`` and ``lower is upper``.
    """

    lower: Affine | None
    upper: Affine | None
    is_point: bool

    @staticmethod
    def point(e: Affine) -> "IndexExpr":
        return IndexExpr(e, e, True)

    @staticmethod
    def slice_(lo: Affine | None, hi: Affine | None) -> "IndexExpr":
        return IndexExpr(lo, hi, False)

    def interval(
        self, env: Mapping[str, tuple[int, int]], extent: int
    ) -> tuple[int, int]:
        """Half-open interval accessed along this axis for thread ranges
        ``env`` and an array axis of ``extent`` elements.  Out-of-bounds
        accesses are clipped to the extent (the paper's kernels guard with
        bounds checks; clipping matches runtime behaviour)."""
        lo = 0 if self.lower is None else self.lower.bounds(env)[0]
        hi = extent if self.upper is None else self.upper.bounds(env)[1] + 1
        lo = max(0, min(lo, extent))
        hi = max(lo, min(hi, extent))
        return lo, hi

    def variables(self) -> tuple[str, ...]:
        out: list[str] = []
        for e in (self.lower, self.upper):
            if e is not None:
                out.extend(e.variables())
        return tuple(dict.fromkeys(out))


@dataclasses.dataclass(frozen=True)
class AccessStmt:
    """``mode array[indices]`` — one argument's access pattern."""

    array: str
    mode: str
    indices: tuple[IndexExpr, ...]
    reduce_op: str | None = None

    @property
    def reads(self) -> bool:
        return self.mode in (READ, READWRITE)

    @property
    def writes(self) -> bool:
        return self.mode in (WRITE, READWRITE, REDUCE)

    def region(
        self, env: Mapping[str, tuple[int, int]], shape: Sequence[int]
    ) -> Region:
        """Access region for the given thread-index ranges (the superblock)."""
        if len(shape) != len(self.indices):
            raise AnnotationError(
                f"array {self.array!r}: annotation has {len(self.indices)} "
                f"subscripts but array is rank {len(shape)}"
            )
        return Region(
            tuple(
                ix.interval(env, int(ext)) for ix, ext in zip(self.indices, shape)
            )
        )

    def variables(self) -> tuple[str, ...]:
        out: list[str] = []
        for ix in self.indices:
            out.extend(ix.variables())
        return tuple(dict.fromkeys(out))


@dataclasses.dataclass(frozen=True)
class Annotation:
    """A parsed kernel annotation: bindings + access statements."""

    bindings: tuple[Binding, ...]
    stmts: tuple[AccessStmt, ...]
    source: str = ""

    # -- variable resolution --------------------------------------------------

    def var_axes(self) -> dict[str, tuple[str, int]]:
        """Map bound variable → (space, grid axis)."""
        out: dict[str, tuple[str, int]] = {}
        for b in self.bindings:
            for axis, name in enumerate(b.names):
                if name in out:
                    raise AnnotationError(f"variable {name!r} bound twice")
                out[name] = (b.space, axis)
        return out

    def stmt_for(self, array: str) -> AccessStmt:
        for s in self.stmts:
            if s.array == array:
                return s
        raise KeyError(array)

    def arrays(self) -> tuple[str, ...]:
        return tuple(s.array for s in self.stmts)

    def env_for_superblock(
        self,
        superblock: Region,
        block_shape: Sequence[int] | None = None,
        block_range: Region | None = None,
    ) -> dict[str, tuple[int, int]]:
        """Thread-index ranges for every bound variable within a superblock.

        ``superblock`` is in *global thread* coordinates (a ``Region`` or a
        ``Superblock``, whose ``.threads`` region is used).  ``block``
        variables need either an explicit ``block_range`` or a
        ``block_shape`` to derive the covered block indices; ``local``
        variables range over the block.
        """
        threads = getattr(superblock, "threads", None)
        if threads is not None:
            superblock = threads
        env: dict[str, tuple[int, int]] = {}
        for b in self.bindings:
            for axis, name in enumerate(b.names):
                if axis >= superblock.ndim:
                    raise AnnotationError(
                        f"binding {name!r} indexes grid axis {axis} but the "
                        f"launch grid is rank {superblock.ndim}"
                    )
                glo, ghi = superblock.intervals[axis]
                if b.space == "global":
                    env[name] = (glo, ghi)
                elif b.space == "block":
                    if block_range is not None:
                        env[name] = block_range.intervals[axis]
                    elif block_shape is not None:
                        bs = int(block_shape[axis])
                        env[name] = (glo // bs, (ghi - 1) // bs + 1)
                    else:
                        raise AnnotationError(
                            "block-space binding requires block_shape"
                        )
                elif b.space == "local":
                    if block_shape is None:
                        raise AnnotationError(
                            "local-space binding requires block_shape"
                        )
                    env[name] = (0, int(block_shape[axis]))
        return env

    def __str__(self) -> str:
        return self.source or "<annotation>"


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------
#
# Grammar (whitespace-insensitive):
#   annotation := bindings '=>' stmt (',' stmt)*
#   bindings   := binding (',' binding)*
#   binding    := SPACE (NAME | '[' NAME (',' NAME)* ']')
#   stmt       := MODE NAME '[' subscript (',' subscript)* ']'
#   MODE       := 'read' | 'write' | 'readwrite' | 'reduce' '(' OP ')'
#   subscript  := expr | expr? ':' expr?
#   expr       := term (('+'|'-') term)*
#   term       := INT '*' NAME | NAME '*' INT | INT | NAME | '-' term


class _Tokens:
    _TOKEN_RE = re.compile(
        r"\s*(?:(?P<int>\d+)|(?P<name>[A-Za-z_]\w*)|(?P<sym>=>|[\[\](),:*+\-]))"
    )

    def __init__(self, text: str):
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = self._TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip():
                    raise AnnotationError(
                        f"unexpected character at {pos}: {text[pos:pos+10]!r}"
                    )
                break
            pos = m.end()
            for kind in ("int", "name", "sym"):
                if m.group(kind) is not None:
                    self.toks.append((kind, m.group(kind)))
                    break
        self.i = 0

    def peek(self) -> tuple[str, str] | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise AnnotationError("unexpected end of annotation")
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        kind, v = self.next()
        if v != value:
            raise AnnotationError(f"expected {value!r}, got {v!r}")

    def accept(self, value: str) -> bool:
        tok = self.peek()
        if tok is not None and tok[1] == value:
            self.i += 1
            return True
        return False


def _parse_term(t: _Tokens) -> Affine:
    if t.accept("-"):
        return _parse_term(t).scale(-1)
    kind, v = t.next()
    if kind == "int":
        if t.accept("*"):
            k2, v2 = t.next()
            if k2 != "name":
                raise AnnotationError(f"expected variable after '*', got {v2!r}")
            return Affine.var(v2, int(v))
        return Affine.constant(int(v))
    if kind == "name":
        if t.accept("*"):
            k2, v2 = t.next()
            if k2 != "int":
                raise AnnotationError(
                    f"nonlinear term {v}*{v2}: only linear expressions allowed"
                )
            return Affine.var(v, int(v2))
        return Affine.var(v)
    raise AnnotationError(f"unexpected token {v!r} in index expression")


def _parse_expr(t: _Tokens) -> Affine:
    e = _parse_term(t)
    while True:
        if t.accept("+"):
            e = e + _parse_term(t)
        elif t.accept("-"):
            e = e - _parse_term(t)
        else:
            return e


def _at_expr_start(t: _Tokens) -> bool:
    tok = t.peek()
    return tok is not None and (tok[0] in ("int", "name") or tok[1] == "-")


def _parse_subscript(t: _Tokens) -> IndexExpr:
    lower: Affine | None = None
    if _at_expr_start(t):
        lower = _parse_expr(t)
    if t.accept(":"):
        upper: Affine | None = None
        if _at_expr_start(t):
            upper = _parse_expr(t)
        return IndexExpr.slice_(lower, upper)
    if lower is None:
        raise AnnotationError("empty subscript")
    return IndexExpr.point(lower)


def _parse_binding(t: _Tokens) -> Binding:
    kind, space = t.next()
    if space not in _SPACES:
        raise AnnotationError(
            f"expected binding space {_SPACES}, got {space!r}"
        )
    names: list[str] = []
    if t.accept("["):
        while True:
            k, v = t.next()
            if k != "name":
                raise AnnotationError(f"expected variable name, got {v!r}")
            names.append(v)
            if t.accept("]"):
                break
            t.expect(",")
    else:
        k, v = t.next()
        if k != "name":
            raise AnnotationError(f"expected variable name, got {v!r}")
        names.append(v)
    return Binding(space, tuple(names))


def _parse_stmt(t: _Tokens) -> AccessStmt:
    kind, mode = t.next()
    if mode not in _MODES:
        raise AnnotationError(f"expected access mode {_MODES}, got {mode!r}")
    reduce_op = None
    if mode == REDUCE:
        t.expect("(")
        k, op = t.next()
        if op not in _REDUCE_OPS:
            raise AnnotationError(
                f"reduce op must be one of {_REDUCE_OPS}, got {op!r}"
            )
        reduce_op = op
        t.expect(")")
    k, array = t.next()
    if k != "name":
        raise AnnotationError(f"expected array name, got {array!r}")
    t.expect("[")
    subs = [_parse_subscript(t)]
    while t.accept(","):
        subs.append(_parse_subscript(t))
    t.expect("]")
    return AccessStmt(array, mode, tuple(subs), reduce_op)


def parse(text: str) -> Annotation:
    """Parse an annotation string into an :class:`Annotation`."""
    t = _Tokens(text)
    bindings = [_parse_binding(t)]
    while t.accept(","):
        tok = t.peek()
        if tok is not None and tok[1] in _SPACES:
            bindings.append(_parse_binding(t))
        else:
            raise AnnotationError("expected binding before '=>'")
    t.expect("=>")
    stmts = [_parse_stmt(t)]
    while t.accept(","):
        stmts.append(_parse_stmt(t))
    if t.peek() is not None:
        raise AnnotationError(f"trailing tokens: {t.peek()!r}")
    ann = Annotation(tuple(bindings), tuple(stmts), source=text.strip())
    # Validate: every variable used in a statement must be bound.
    bound = set(ann.var_axes())
    for s in ann.stmts:
        for v in s.variables():
            if v not in bound:
                raise AnnotationError(
                    f"unbound variable {v!r} in access for {s.array!r}"
                )
    # Arrays must appear at most once (one statement per argument).
    seen: set[str] = set()
    for s in ann.stmts:
        if s.array in seen:
            raise AnnotationError(f"array {s.array!r} annotated twice")
        seen.add(s.array)
    return ann
