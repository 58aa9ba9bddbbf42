"""ctypes bridge to the native JPEG decode + resize library
(csrc/host/jpeg_decode.cc; counterpart of
dinov2_od_tpu/data/native_decode.py).

The C path replaces the per-image Python work of a Pillow decode and
resize: libjpeg's DCT-domain scaled decode with the full M/8 scale
ladder, then a fused bilinear resize into a caller buffer. Its pixels
are not Pillow's (another resampling), so parity runs decode with
'pil'.

Both entry points release the GIL for the whole decode (plain ctypes
calls), so the threaded DataLoader scales across cores without worker
processes; `decode_batch` also runs its own C thread pool.

The library builds at first use (g++ ... -ljpeg -lpthread, under a file
lock: utils/host_lib.py). Where it cannot be built (no g++ or no libjpeg
headers) `get_lib` raises with the compiler's output. A file the decoder
rejects (corrupt, CMYK) gives None from `decode_one` and a failed slot
from `decode_batch`, and the caller decodes that image another way.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils import host_lib

SOURCE = "jpeg_decode.cc"
LIBS = ("jpeg", "pthread")

_lib = None


def get_lib() -> ctypes.CDLL:
    """The decoder library, built first if needed; raises RuntimeError
    when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        lib = host_lib.load(SOURCE, LIBS)
        lib.jpeg_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.jpeg_decode_resize.restype = ctypes.c_int
        lib.jpeg_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.jpeg_decode_resize_batch.restype = None
        _lib = lib
    return _lib


def decode_one(path: str, image_size: int) -> Optional[np.ndarray]:
    """Decode + resize one JPEG to [S, S, 3] uint8 RGB; None when the
    decoder rejects the file (the caller decodes it another way)."""
    lib = get_lib()
    out = np.empty((image_size, image_size, 3), np.uint8)
    rc = lib.jpeg_decode_resize(
        path.encode(), image_size, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if rc == 0 else None


def decode_batch(paths: Sequence[str], image_size: int,
                 num_threads: int = 0) -> Tuple[np.ndarray, List[int]]:
    """One-call batch decode into a contiguous [N, S, S, 3] uint8 slab by
    the C thread pool (num_threads <= 0: one thread a core). Returns
    (batch, failed_indices); a failed slot holds no image and the caller
    decodes it another way."""
    lib = get_lib()
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.uint8)
    status = np.zeros(n, np.int32)
    if n == 0:
        return out, []
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.jpeg_decode_resize_batch(
        arr, n, image_size, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(num_threads),
    )
    return out, np.nonzero(status != 0)[0].tolist()
