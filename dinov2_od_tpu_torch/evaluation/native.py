"""ctypes bridge to the C++ COCO-eval matching library
(csrc/host/coco_eval.cc; counterpart of dinov2_od_tpu/evaluation/native.py).

The library builds at first use with g++ under a file lock
(utils/host_lib.py). `get_lib` raises with the compiler's output where it
cannot be built; `available` says whether it can, and the evaluator then
takes the numpy path (evaluation/coco_metrics.py), the reference the C++
path is held equal to.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from ..utils import host_lib

logger = logging.getLogger(__name__)

SOURCE = "coco_eval.cc"

_lib = None
_warned = False


def get_lib() -> ctypes.CDLL:
    """The matching library, built first if needed; raises RuntimeError
    when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        lib = host_lib.load(SOURCE)
        lib.cocoeval_match_cell.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # dt_boxes, n_dt
            ctypes.POINTER(ctypes.c_double),                   # gt_boxes
            ctypes.POINTER(ctypes.c_int32),                    # gt_ignore
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,    # gt_crowd, n_gt
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # iou_thrs, n_thr
            ctypes.c_double, ctypes.c_double,                  # area range
            ctypes.POINTER(ctypes.c_int64),                    # dtm out
            ctypes.POINTER(ctypes.c_uint8),                    # dt_ignore out
        ]
        lib.cocoeval_match_cell.restype = None
        lib.cocoeval_match_category.argtypes = [
            ctypes.POINTER(ctypes.c_double),                   # dt_boxes
            ctypes.POINTER(ctypes.c_int64),                    # dt_off
            ctypes.POINTER(ctypes.c_double),                   # gt_boxes
            ctypes.POINTER(ctypes.c_int32),                    # gt_crowd
            ctypes.POINTER(ctypes.c_double),                   # gt_area
            ctypes.POINTER(ctypes.c_int64),                    # gt_off
            ctypes.c_int64,                                    # n_img
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # iou_thrs, n_thr
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # area_rngs, n_area
            ctypes.POINTER(ctypes.c_int32),                    # dtm out
            ctypes.POINTER(ctypes.c_uint8),                    # dt_ignore out
            ctypes.POINTER(ctypes.c_int32),                    # num_gt out
        ]
        lib.cocoeval_match_category.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (logged once when not)."""
    global _warned
    try:
        get_lib()
    except RuntimeError as e:
        if not _warned:
            _warned = True
            logger.warning("C++ COCO matcher unavailable, numpy path: %s", e)
        return False
    return True


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def match_cell_native(
    dt_boxes: np.ndarray,      # [n_dt, 4] sorted by score desc, <= max_det
    gt_boxes: np.ndarray,      # [n_gt, 4] sorted non-ignored first
    gt_ignore: np.ndarray,     # [n_gt] int32
    gt_crowd: np.ndarray,      # [n_gt] int32
    iou_thrs: np.ndarray,
    area_rng,
):
    """Greedy matching of one (image, category) cell by the C++ kernel.
    The caller sorts as the comments say. Returns (dtm [T, n_dt] int64,
    dt_ignore [T, n_dt] bool)."""
    lib = get_lib()
    n_dt, n_gt, n_thr = len(dt_boxes), len(gt_boxes), len(iou_thrs)
    dt_boxes = np.ascontiguousarray(dt_boxes, np.float64)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.int32)
    gt_crowd = np.ascontiguousarray(gt_crowd, np.int32)
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    dtm = np.zeros((n_thr, n_dt), np.int64)
    dt_ig = np.zeros((n_thr, n_dt), np.uint8)
    lib.cocoeval_match_cell(
        _ptr(dt_boxes, ctypes.c_double), n_dt,
        _ptr(gt_boxes, ctypes.c_double),
        _ptr(gt_ignore, ctypes.c_int32),
        _ptr(gt_crowd, ctypes.c_int32), n_gt,
        _ptr(thrs, ctypes.c_double), n_thr,
        float(area_rng[0]), float(area_rng[1]),
        _ptr(dtm, ctypes.c_int64),
        _ptr(dt_ig, ctypes.c_uint8),
    )
    return dtm, dt_ig.astype(bool)


def match_category_native(
    dt_boxes: np.ndarray,    # [total_dt, 4] per-image segments, score-desc
    dt_off: np.ndarray,      # [n_img+1] int64
    gt_boxes: np.ndarray,    # [total_gt, 4]
    gt_crowd: np.ndarray,    # [total_gt] int32
    gt_area: np.ndarray,     # [total_gt] float64
    gt_off: np.ndarray,      # [n_img+1] int64
    iou_thrs: np.ndarray,
    area_rngs: np.ndarray,   # [n_area, 2] float64
):
    """Batched per-category matching (csrc/host/coco_eval.cc
    cocoeval_match_category): every image of one category in one call,
    each image's IoU table computed once for all area ranges. Returns
    (dtm [A, T, N] int32, dt_ignore [A, T, N] bool, num_gt [A] int32)."""
    lib = get_lib()
    n_img = len(dt_off) - 1
    n_thr, n_area = len(iou_thrs), len(area_rngs)
    total_dt = int(dt_off[-1])
    dt_boxes = np.ascontiguousarray(dt_boxes, np.float64)
    dt_off = np.ascontiguousarray(dt_off, np.int64)
    gt_boxes = np.ascontiguousarray(gt_boxes, np.float64)
    gt_crowd = np.ascontiguousarray(gt_crowd, np.int32)
    gt_area = np.ascontiguousarray(gt_area, np.float64)
    gt_off = np.ascontiguousarray(gt_off, np.int64)
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    rngs = np.ascontiguousarray(area_rngs, np.float64)
    dtm = np.zeros((n_area, n_thr, total_dt), np.int32)
    dt_ig = np.zeros((n_area, n_thr, total_dt), np.uint8)
    num_gt = np.zeros(n_area, np.int32)
    lib.cocoeval_match_category(
        _ptr(dt_boxes, ctypes.c_double), _ptr(dt_off, ctypes.c_int64),
        _ptr(gt_boxes, ctypes.c_double), _ptr(gt_crowd, ctypes.c_int32),
        _ptr(gt_area, ctypes.c_double), _ptr(gt_off, ctypes.c_int64),
        n_img,
        _ptr(thrs, ctypes.c_double), n_thr,
        _ptr(rngs, ctypes.c_double), n_area,
        _ptr(dtm, ctypes.c_int32),
        _ptr(dt_ig, ctypes.c_uint8),
        _ptr(num_gt, ctypes.c_int32),
    )
    return dtm, dt_ig.astype(bool), num_gt
