"""Builds ``repro_torch/csrc/*.cu`` into one shared library at first use.

``nvcc`` compiles each source for ``sm_90a`` (all sources started together,
one compiler process each), links them into ``libkernels.so`` and the result
is loaded with ``ctypes``: the sources expose a plain C interface, so a build
takes seconds.  The library lands in ``build/repro_torch/`` at the root of a
checkout, or in ``build/`` beside the package when the package is installed
elsewhere.  A stamp file holds a hash of the sources and the flags, so an
edited ``.cu`` rebuilds.  A missing compiler or a failed build raises with
the compiler's output.  A file lock beside the library makes concurrent
processes (the ranks of one machine) build it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
CUTLASS_INCLUDE = Path("/usr/local/cutlass/include")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
#: seconds the last build in this process took (0.0 when the library on
#: disk was up to date)
build_seconds: float = 0.0


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    root = PACKAGE_DIR.parent.parent  # <root>/src/repro_torch in a checkout
    if PACKAGE_DIR.parent.name == "src" and (root / "pyproject.toml").exists():
        return root / "build" / "repro_torch"
    return PACKAGE_DIR / "build"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built here"
    )


def _digest(srcs: list[Path], flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(srcs: list[Path] | None = None, defines: tuple[str, ...] = (),
          out: Path | None = None) -> Path:
    """Compile the sources (every one under ``csrc/`` by default, each with
    ``-D`` of ``defines``) into ``out`` (``build_dir()`` by default) if the
    library there is missing or stale; return its path.  The compiler's
    output is kept in ``build.log`` beside it.  The package's library is
    the default; a probe builds variants of a source into a directory of
    its own."""
    srcs = sources() if srcs is None else srcs
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = build_dir() if out is None else out
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    lib_path, stamp = out / "libkernels.so", out / "libkernels.hash"
    digest = _digest(srcs, flags)
    if (lib_path.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return lib_path
    out.mkdir(parents=True, exist_ok=True)
    # One build at a time (several ranks may ask at once): the others wait
    # for the lock and then find the library up to date.
    with open(out / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (lib_path.exists() and stamp.exists()
                and stamp.read_text() == digest):
            return lib_path
        return _compile(srcs, flags, _include(), out, lib_path, stamp,
                        digest)


def _include() -> list[str]:
    include = ["-I", str(CSRC_DIR)]
    if CUTLASS_INCLUDE.is_dir():
        include += ["-I", str(CUTLASS_INCLUDE)]
    return include


def _compile(srcs: list[Path], flags: tuple[str, ...], include: list[str],
             out: Path, lib_path: Path, stamp: Path, digest: str) -> Path:
    global build_seconds
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *flags, *include, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = out / f"libkernels.{os.getpid()}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(log))
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return lib_path


def build_log(out: Path | None = None) -> str:
    path = (build_dir() if out is None else out) / "build.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built on the first call in a process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


_bound: dict[str, "ctypes._CFuncPtr"] = {}


def bind(name: str, argtypes: list) -> "ctypes._CFuncPtr":
    """One C launcher with its argument types set (pointers and the stream
    as ``c_void_p``, or ctypes would cut them to 32 bits), bound once per
    process: a decode step calls each launcher once a layer.  Every
    launcher returns ``cudaGetLastError()`` as an int."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a launcher's nonzero return: a ``cudaError_t``, or the
    negated ``CUresult`` of a TMA tensor map the driver would not encode."""
    if err < 0:
        raise RuntimeError(f"{what}: the driver refused a TMA tensor map "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {err}")
