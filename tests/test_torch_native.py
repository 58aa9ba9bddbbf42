"""The port's host C++ libraries (csrc/host/{coco_eval,jpeg_decode}.cc,
built by utils/host_lib.py) on the CPU:

- the C++ COCO matcher equal to the numpy matcher on random cells
  (parametrised as tests/test_native_eval.py), and the port's
  CocoEvaluator, with either matcher, equal to the JAX package's;
- the native JPEG decoder bit-equal to the JAX package's C source
  (native/jpeg_decode.cc, compiled here and called through ctypes) and
  within a stated distance of Pillow's decode on 640 px JPEGs;
- `decode_batch` equal to `decode_one`; a CMYK JPEG and a corrupt file
  reported as failures and decoded by the caller another way; a file
  that is not a JPEG never reaching the decoder;
- two processes building one library at once, both loading the one
  build (the file lock).
"""

import ctypes
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from dinov2_od_tpu.evaluation.coco_metrics import \
    CocoEvaluator as JaxEvaluator

from dinov2_od_tpu_torch.data import coco, native_decode
from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
from dinov2_od_tpu_torch.evaluation import native
from dinov2_od_tpu_torch.evaluation.coco_metrics import (
    IOU_THRS, CocoEvaluator, _greedy_match_from_ious, bbox_iou_xywh)
from dinov2_od_tpu_torch.tools.bench_evaluator import synth
from dinov2_od_tpu_torch.utils import host_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The native decoder against Pillow on the 640 px synthetic JPEGs at 224:
# another resampling (M/8 DCT scaling + half-pixel bilinear against a
# full decode + Pillow's bilinear), measured at most 1.06 mean and 34 max
# absolute difference per channel (of 255) on these eight images.
PIL_MEAN_TOL = 1.5
PIL_MAX_TOL = 48


def _random_cell(rng, n_dt, n_gt):
    dt_boxes = np.concatenate(
        [rng.uniform(0, 200, (n_dt, 2)), rng.uniform(5, 80, (n_dt, 2))], axis=1)
    dt_scores = rng.uniform(0, 1, n_dt)
    gt_boxes = np.concatenate(
        [rng.uniform(0, 200, (n_gt, 2)), rng.uniform(5, 80, (n_gt, 2))], axis=1)
    gt_crowd = (rng.uniform(size=n_gt) < 0.15).astype(np.int64)
    # Crowd implies ignore in the protocol.
    gt_ignore = np.maximum((rng.uniform(size=n_gt) < 0.2).astype(np.int64),
                           gt_crowd)
    return dt_boxes, dt_scores, gt_boxes, gt_ignore, gt_crowd


@pytest.mark.parametrize("n_dt,n_gt",
                         [(0, 3), (5, 0), (8, 5), (40, 20), (120, 60)])
def test_native_cell_matcher_equal_to_numpy(rng, n_dt, n_gt):
    dt_boxes, dt_scores, gt_boxes, gt_ignore, gt_crowd = _random_cell(
        rng, n_dt, n_gt)
    g = np.argsort(gt_ignore, kind="stable")  # non-ignored GT first
    gt_boxes, gt_ig, crowd = gt_boxes[g], gt_ignore[g], gt_crowd[g]
    for area_rng in [(0.0, 1e10), (0.0, 32.0**2), (32.0**2, 96.0**2)]:
        for max_det in (1, 10, 100):
            d = np.argsort(-dt_scores, kind="stable")[:max_det]
            dts = dt_boxes[d]
            want = _greedy_match_from_ious(
                bbox_iou_xywh(dts, gt_boxes, crowd.astype(bool)),
                dts[:, 2] * dts[:, 3], gt_ig.astype(bool),
                crowd.astype(bool), area_rng)
            got = native.match_cell_native(dts, gt_boxes, gt_ig, crowd,
                                           IOU_THRS, area_rng)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    """The bench_evaluator's synthetic GT and detections at 40 images,
    with a few crowd regions, as a GT file."""
    gt, dets = synth(n_img=40, n_cat=6, anns_per_img=5, dets_per_img=30,
                     seed=3)
    path = tmp_path_factory.mktemp("eval") / "gt.json"
    path.write_text(json.dumps(gt))
    return str(path), dets


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_evaluator_equal_to_jax(eval_set, use_native):
    path, dets = eval_set
    ev = CocoEvaluator(path, use_native=use_native)
    got = ev.evaluate(dets)
    assert ev.matcher == ("native" if use_native else "numpy")
    assert got == JaxEvaluator(path).evaluate(dets)
    assert 0 < got["AP"] < 1


def test_evaluator_picks_native_where_it_builds(eval_set, monkeypatch):
    path, dets = eval_set
    ev = CocoEvaluator(path)
    native_metrics = ev.evaluate(dets)
    assert ev.matcher == "native"

    def no_build():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "get_lib", no_build)
    ev = CocoEvaluator(path)
    assert ev.evaluate(dets) == native_metrics and ev.matcher == "numpy"
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        CocoEvaluator(path, use_native=True).evaluate(dets)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Eight 640 px synthetic JPEGs (the bench_input set's writer)."""
    images_dir, _ = write_coco_dataset(
        str(tmp_path_factory.mktemp("jpg640")), num_images=8,
        image_size=640, seed=0, fmt="jpg")
    return sorted(os.path.join(images_dir, f) for f in os.listdir(images_dir))


@pytest.fixture(scope="module")
def jax_c_decoder(tmp_path_factory):
    """The JAX package's C source (native/jpeg_decode.cc) compiled here
    and loaded with ctypes: decode_resize(path, size) -> array or None."""
    out = tmp_path_factory.mktemp("jaxc") / "libjpegdecode_jax.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o",
                    str(out), os.path.join(REPO, "native", "jpeg_decode.cc"),
                    "-ljpeg", "-lpthread"], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.jpeg_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte)]
    lib.jpeg_decode_resize.restype = ctypes.c_int

    def decode(path, size):
        arr = np.empty((size, size, 3), np.uint8)
        rc = lib.jpeg_decode_resize(
            path.encode(), size, size,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        return arr if rc == 0 else None

    return decode


@pytest.mark.parametrize("size", [224, 96, 700])
def test_decode_one_bit_equal_to_jax_c_source(jpegs, jax_c_decoder, size):
    for p in jpegs[:4]:
        got = native_decode.decode_one(p, size)
        assert got is not None and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, jax_c_decoder(p, size))


def test_decode_one_near_pil(jpegs):
    for p in jpegs:
        diff = np.abs(native_decode.decode_one(p, 224).astype(np.int16)
                      - coco.decode_pil(p, 224)).reshape(-1, 3)
        assert diff.mean(axis=0).max() <= PIL_MEAN_TOL, p
        assert diff.max() <= PIL_MAX_TOL, p


def _cmyk_and_corrupt(tmp_path):
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.new("CMYK", (64, 48), (20, 120, 200, 10)).save(cmyk)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"definitely not a jpeg")
    return cmyk, bad


def test_decode_batch_equal_to_decode_one(jpegs, tmp_path):
    cmyk, bad = _cmyk_and_corrupt(tmp_path)
    paths = [jpegs[0], cmyk, *jpegs[1:4], bad]
    batch, failed = native_decode.decode_batch(paths, 96, num_threads=3)
    assert batch.shape == (6, 96, 96, 3) and failed == [1, 5]
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(batch[i],
                                      native_decode.decode_one(paths[i], 96))
    assert native_decode.decode_batch([], 96)[1] == []


def test_cmyk_and_corrupt_fail_and_are_redecoded(tmp_path):
    cmyk, bad = _cmyk_and_corrupt(tmp_path)
    assert native_decode.decode_one(cmyk, 32) is None
    assert native_decode.decode_one(bad, 32) is None
    # The caller decodes the CMYK file another way (cv2 where it imports).
    fallback = coco.decode_cv2 if coco._cv2() else coco.decode_pil
    np.testing.assert_array_equal(coco.decode_image(cmyk, 32, "native"),
                                  fallback(cmyk, 32))
    with pytest.raises(Exception):  # neither cv2 nor Pillow reads it
        coco.decode_image(bad, 32, "native")


def test_non_jpeg_bypasses_the_decoder(tmp_path, monkeypatch):
    png = str(tmp_path / "img.png")
    Image.fromarray(np.full((40, 40, 3), 77, np.uint8)).save(png)

    def never(*a):
        raise AssertionError("a PNG reached the JPEG decoder")

    monkeypatch.setattr(native_decode, "decode_one", never)
    out = coco.decode_image(png, 32, "native")
    assert out.shape == (32, 32, 3)
    assert np.abs(out.astype(np.int16) - 77).max() <= 2


def test_two_processes_build_one_library(tmp_path):
    """Two processes build the decoder into an empty directory at once
    under the lock: both load it, and one library is left, no temp file."""
    code = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {REPO!r})
        from dinov2_od_tpu_torch.utils import host_lib
        path = host_lib.build("jpeg_decode.cc", ("jpeg", "pthread"),
                              build_dir={str(tmp_path)!r})
        ctypes.CDLL(str(path)).jpeg_decode_resize
        print(path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0][0] == outs[1][0]
    assert sorted(f for f in os.listdir(tmp_path) if not f.endswith(".lock")
                  ) == [os.path.basename(outs[0][0].strip())]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build"):
        host_lib.build("coco_eval.cc", build_dir=tmp_path)
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path))


def test_port_loads_no_library_of_the_jax_package():
    """The port builds its own copies of the C++ sources, inside its
    package, and names none of the JAX package's libraries or its make."""
    assert host_lib.HOST_SRC.parent.parent.name == "dinov2_od_tpu_torch"
    assert host_lib.BUILD_DIR.is_relative_to(host_lib.PACKAGE)
    for name in ("jpeg_decode.cc", "coco_eval.cc"):
        assert (host_lib.HOST_SRC / name).exists()
    pkg = os.path.join(REPO, "dinov2_od_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for word in ("libcocoeval", "libjpegdecode", "make -C",
                             "native/lib"):
                    assert word not in text, (f, word)
