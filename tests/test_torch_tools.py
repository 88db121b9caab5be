"""The scripts that measure the port on the card: every name their
functions read resolves (a name a function reads but nothing defines fails
only when that function runs, on the card), and the bounds they compute
are least times."""

import builtins
import importlib
import itertools
import symtable
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
#: the scripts that measure the port, by module name (chip_smoke.py at the
#: root, the rest in tools/)
SCRIPTS = ["chip_smoke", "cuda_core_probe", "tensor_core_probe",
           "decode_step_ab", "decode_splits", "depth_divergence"]


def global_reads(source: str, filename: str) -> set[str]:
    """The names a function, class or lambda of ``source`` reads from the
    module's scope or the builtins."""
    names = set()

    def walk(table):
        for sym in table.get_symbols():
            if (table.get_type() != "module" and sym.is_referenced()
                    and sym.is_global()):
                names.add(sym.get_name())
        for child in table.get_children():
            walk(child)

    walk(symtable.symtable(source, filename, "exec"))
    return names


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_names_resolve(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    monkeypatch.syspath_prepend(str(ROOT))
    module = importlib.import_module(name)
    path = Path(module.__file__)
    missing = sorted(n for n in global_reads(path.read_text(), str(path))
                     if not hasattr(module, n) and not hasattr(builtins, n))
    assert not missing, f"{path.name} reads names it never defines: {missing}"


def test_global_reads_sees_a_missing_import():
    """The scan finds a name a nested function reads but nobody imports."""
    source = ("from os import path\n"
              "def outer():\n"
              "    def inner(x):\n"
              "        return spmv_check(x) + path.sep\n"
              "    return inner\n")
    assert global_reads(source, "<probe>") == {"spmv_check", "path"}


def _md5_grid_seconds(smoke, ops, r, g):
    """One key's time with r rotate-adds as two FMA-pipe instructions and g
    of the plain adds on the FMA pipe (the rest on the ALU pipe)."""
    alu = ops["alu_only"] + ops["rotate_adds"] - r + ops["adds"] - g
    fma = 2 * r + g
    return max((ops["total"] + r) / smoke.H100_SXM_INT32_OPS,
               alu / smoke.H100_SXM_INT32_ALU_OPS,
               fma / smoke.H100_SXM_INT32_ALU_OPS)


def test_md5_bound_is_the_least_time_over_the_pipes(monkeypatch):
    """md5_seconds_per_key is the least, over every split of the rotate-adds
    and the adds between the ALU and the FMA pipe (a grid of eighths), of
    the largest of the issue time and each pipe's time; it lies below the
    time of the ALU-only count on the ALU pipe and above the issue time of
    the count."""
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    ops = smoke.md5_int_ops_per_key()
    assert ops == {"total": 163, "alu_only": 53, "rotate_adds": 52,
                   "adds": 58}
    least, moved = smoke.md5_seconds_per_key(ops)
    grid = min(_md5_grid_seconds(smoke, ops, r / 8, g / 8)
               for r, g in itertools.product(range(8 * ops["rotate_adds"] + 1),
                                             range(8 * ops["adds"] + 1)))
    assert least <= grid * (1 + 1e-12)
    assert grid <= least * (1 + 1e-3)
    assert 0 < moved < ops["rotate_adds"]
    assert least < (ops["alu_only"] + ops["rotate_adds"]) \
        / smoke.H100_SXM_INT32_ALU_OPS
    assert least > ops["total"] / smoke.H100_SXM_INT32_OPS
    ms, by = smoke.md5_work(1 << 30)
    assert by == "operations"
    assert ms == pytest.approx((1 << 30) * least * 1e3, rel=1e-12)
