"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under `csrc/` compiles with `nvcc` for sm_90a into a shared
library with a plain C interface. The library's file name carries a hash
of its source and of the shared headers (`csrc/*.cuh`), so an edited
source rebuilds and an unchanged one loads the library already built.
Builds go to `csrc/_build/` inside the package (listed in .gitignore);
`build_all` starts one `nvcc` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
           "attn_roofline": "attn_roofline.cu",
           "auction": "auction.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # ptxas register/spill report per source
# Launches per kernel. A wrapper adds one right where it launches its
# kernel and nowhere else, so a run can show that it went through it.
launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}
# Launches made through a route that rides those kernels (B3,
# `flash_attention_lse`: its forward's and its backward's), counted apart
# from them and beside them.
route_counts: Dict[str, int] = {"flash_attention_lse": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for name in counts:
            counts[name] = 0


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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
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


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_log(name: str) -> str:
    """ptxas's `-v` report of kernel `name`: this process's build's, else
    from compiling the source once more (the built library stays)."""
    if name not in build_logs:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"ptxas_{name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        tmp.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        build_logs[name] = proc.stdout
    return build_logs[name]


def ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: registers, stack, spill stores and loads in
    bytes} from an `nvcc -Xptxas -v` log (`build_logs[name]`)."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": 0, "stack": 0, "spill_stores": 0,
                       "spill_loads": 0}
            continue
        if fn is None:
            continue
        m = _PROPS.search(line)
        if m:
            out[fn].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _loaded:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
