"""Build and load the port's native libraries: the CUDA kernels
(``csrc/*.cu``) and the host C++ data loader (``csrc/*.cc``).

A ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``), a
``.cc`` source by the host's ``g++`` (``CXX``), each into a shared library
with a plain C interface, loaded with ``ctypes``. Libraries are
cached in ``pytorch_distributed_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, the
``csrc/`` headers it includes and the flags, so an edited source or header
rebuilds and an unchanged one loads at once.
Nothing here runs at import: the first kernel call builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
             "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA toolkit is "
        "needed to build the port's kernels"
    )


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            "no host C++ compiler (g++ or $CXX) on PATH: the port's native "
            "data loader is built from csrc/*.cc with one"
        )
    return cxx


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` or, for host code, ``csrc/<name>.cc``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def _command(name: str) -> list[str]:
    src = _source(name)
    if src.suffix == ".cc":
        return [_cxx(), *CXX_FLAGS]
    return [_nvcc(), *NVCC_FLAGS]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every file under ``csrc/`` it includes with quotes,
    depth first, each once."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.is_file():
            _sources(dep, seen)
    return seen


def _target(name: str) -> Path:
    """The cached library's path: its name carries a hash of the source,
    the headers it includes and the flags."""
    src = _source(name)
    flags = CXX_FLAGS if src.suffix == ".cc" else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _sources(src, []):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Build ``csrc/<name>.cu`` (or ``.cc``) unless its cached library
    exists. Returns {"path", "seconds", "cached", "log"}; raises with the
    compiler's output if the build fails."""
    target = _target(name)
    if target.exists():
        return dict(path=str(target), seconds=0.0, cached=True, log="")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    src = _source(name)
    cmd = _command(name)
    # Through the port's launcher: the compiler's process group dies with
    # an interrupted build (parallel/mesh.run).
    from pytorch_distributed_tpu_torch.parallel.mesh import run

    proc = run([*cmd, "-o", str(tmp), str(src)], timeout=None)
    if proc.returncode:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed to build csrc/{src.name} "
            f"(exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half
    return dict(path=str(target), seconds=time.perf_counter() - t0,
                cached=False, log=proc.stdout)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cc``), building
    it first if needed (once per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        _loaded[name] = lib
    return lib
