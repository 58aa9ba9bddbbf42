"""A world of CPU ranks, one process each, for the multi-process tests
(tests/test_torch_multihost.py, tests/test_torch_mesh_cli*.py).

`Ranks` starts `world` processes, each from `argv(rank, port)`, with one
intra-op thread (`OMP_NUM_THREADS=1`: the suite's workers share the
host's cores) and the repository on PYTHONPATH; each writes its output to
LOG_DIR/{tag}{rank}.log. `wait` gives each rank's log once every rank
has exited 0. A rank that exits non-zero, or a world that outlives its
timeout, fails the test, its peers killed first so that nothing lingers.
The port is a free one picked per world; when rank 0 could not bind it
(another world took it in between), the world starts once more on
another port.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PYTHON = sys.executable
TIMEOUT = 300


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Ranks:
    def __init__(self, argv, world: int, log_dir, env=None,
                 tag: str = "rank", timeout: float = TIMEOUT):
        self.argv, self.world, self.tag = argv, world, tag
        self.log_dir, self.timeout = Path(log_dir), timeout
        self.env = env or (lambda rank, port: {})
        self.procs = []
        self.start()

    def start(self) -> "Ranks":
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.port = free_port()
        base = {**os.environ, "PYTHONPATH": str(REPO),
                "OMP_NUM_THREADS": "1"}
        self.procs = []
        for r in range(self.world):
            with open(self.log(r), "wb") as log:
                self.procs.append(subprocess.Popen(
                    [PYTHON] + [str(a) for a in self.argv(r, self.port)],
                    cwd=REPO, env={**base, **self.env(r, self.port)},
                    stdout=log, stderr=subprocess.STDOUT))
        self.t0 = time.monotonic()
        return self

    def log(self, rank: int) -> Path:
        return self.log_dir / f"{self.tag}{rank}.log"

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self, retry: bool = True) -> list:
        """Each rank's output, once all have exited 0."""
        while any(p.poll() is None for p in self.procs):
            failed = [r for r, p in enumerate(self.procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() - self.t0 > self.timeout:
                break
            time.sleep(0.05)
        codes = [p.poll() for p in self.procs]
        self.kill()
        logs = [self.log(r).read_text(errors="replace")
                for r in range(self.world)]
        if all(c == 0 for c in codes):
            return logs
        if retry and "ddress already in use" in logs[0]:
            return self.start().wait(retry=False)
        bad = next((r for r, c in enumerate(codes) if c not in (0, None)),
                   0)
        raise AssertionError(
            f"ranks exited {codes} (None: killed at the {self.timeout} s "
            f"timeout); rank {bad}:\n{logs[bad][-4000:]}")
