"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under `csrc/` compiles with `nvcc` for sm_90a into a shared
library with a plain C interface. The library's file name carries a hash
of its source, so an edited source rebuilds and an unchanged one loads the
library already built. Builds go to `csrc/_build/` inside the package
(listed in .gitignore); `build_all` starts one `nvcc` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = {"flash_attn_fwd": "flash_attn_fwd.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "flash_attn_bhsd_fwd": "flash_attn_bhsd_fwd.cu",
           "flash_attn_bhsd_bwd": "flash_attn_bhsd_bwd.cu",
           "flash_attn_allheads_fwd": "flash_attn_allheads_fwd.cu",
           "flash_attn_allheads_bwd": "flash_attn_allheads_bwd.cu",
           "int8_gemm": "int8_gemm.cu",
           "attn_roofline": "attn_roofline.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # ptxas register/spill report per source
# Launches per kernel. A wrapper adds one right where it launches its
# kernel and nowhere else, so a run can show that it went through it.
launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build_all(names=None) -> None:
    """Compile every listed source whose library is missing, all `nvcc`
    processes at once; raise with the compiler output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {n: _start(n) for n in names if not _lib_path(n).exists()}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _loaded:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
