"""Builds the port's host C++ libraries (`csrc/host/*.cc`) with g++ at
first use and loads them with ctypes.

- The library's file name carries a hash of its source, the compiler's
  version line, the flags and the linked libraries, so an edited source
  or another compiler rebuilds and an unchanged one loads the library
  already built (in `csrc/_build/`, which .gitignore lists, beside the
  CUDA kernels' libraries).
- One build at a time: every process takes an exclusive `fcntl` lock
  on the library's lock file, checks again whether another process built
  it meanwhile, compiles to a name of its own and renames the result into
  place. A reader never sees a half-written library, and test workers
  started at once all load the one build.
- A build that fails raises RuntimeError with the compiler's output; the
  failure is remembered, so the process does not run g++ again for it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parent.parent
HOST_SRC = PACKAGE / "csrc" / "host"
BUILD_DIR = PACKAGE / "csrc" / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_failed: Dict[Tuple[str, Tuple[str, ...]], RuntimeError] = {}


def _compiler() -> Tuple[str, str]:
    """(the C++ compiler, its version line); raises where there is none."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("cannot build the host libraries: no g++ on PATH")
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {cxx}: {e}") from e
    return cxx, (version.splitlines() or [""])[0]


def lib_path(source: str, libs: Sequence[str] = (),
             build_dir: Path = BUILD_DIR, compiler: str = "") -> Path:
    """Where the library of `source` (a file of csrc/host/) is built by
    the compiler whose version line is `compiler`."""
    digest = hashlib.sha1(
        (HOST_SRC / source).read_bytes()
        + " ".join((compiler, *CXX_FLAGS, *libs)).encode()).hexdigest()
    return Path(build_dir) / f"lib{Path(source).stem}_{digest[:12]}.so"


def build(source: str, libs: Sequence[str] = (),
          build_dir: Path = BUILD_DIR) -> Path:
    """The built library of `source`, compiled under the lock if it is
    missing; raises RuntimeError with g++'s output if it does not build."""
    cxx, version = _compiler()
    out = lib_path(source, libs, build_dir, version)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(HOST_SRC / source),
                   *(f"-l{lib}" for lib in libs)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"g++ failed to build {source} ({' '.join(cmd)}):\n"
                    f"{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load(source: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed. Raises
    RuntimeError (the same one on every call) when it cannot be built or
    loaded."""
    key = (source, tuple(libs))
    if key in _loaded:
        return _loaded[key]
    if key in _failed:
        raise _failed[key]
    try:
        _loaded[key] = ctypes.CDLL(str(build(source, libs)))
    except OSError as e:
        _failed[key] = RuntimeError(f"cannot load the library of {source}: "
                                    f"{e}")
        raise _failed[key] from e
    except RuntimeError as e:
        _failed[key] = e
        raise
    return _loaded[key]
