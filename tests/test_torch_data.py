"""The port's data path (dinov2_od_tpu_torch/data/{synthetic,coco,loader,
packed}.py) against the JAX package's on the same synthetic COCO files,
on the CPU. Everything here is exact: the same files byte for byte, the
same decoded pixels and targets, the same batch order.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from dinov2_od_tpu.data import coco as jcoco
from dinov2_od_tpu.data import loader as jloader
from dinov2_od_tpu.data import packed as jpacked
from dinov2_od_tpu.data.synthetic import write_coco_dataset as jax_write

from dinov2_od_tpu_torch.data import coco as pcoco
from dinov2_od_tpu_torch.data import loader as ploader
from dinov2_od_tpu_torch.data import native_decode
from dinov2_od_tpu_torch.data import packed as ppacked
from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    images_dir, ann = write_coco_dataset(str(root), num_images=10,
                                         image_size=40, seed=4,
                                         max_objects=3)
    return images_dir, ann


def test_write_coco_dataset_byte_equal_to_jax(tmp_path, synth):
    images_dir, ann = synth
    j_images, j_ann = jax_write(str(tmp_path), num_images=10, image_size=40,
                                seed=4, max_objects=3)
    with open(ann, "rb") as a, open(j_ann, "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(images_dir))
    assert names == sorted(os.listdir(j_images)) and len(names) == 10
    for n in names:
        assert filecmp.cmp(os.path.join(images_dir, n),
                           os.path.join(j_images, n), shallow=False)
    jpg = write_coco_dataset(str(tmp_path / "p"), num_images=2,
                             image_size=32, seed=1, fmt="jpg")
    jjpg = jax_write(str(tmp_path / "j"), num_images=2, image_size=32,
                     seed=1, fmt="jpg")
    for n in sorted(os.listdir(jpg[0])):
        assert filecmp.cmp(os.path.join(jpg[0], n), os.path.join(jjpg[0], n),
                           shallow=False)


def _equal_examples(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("output_dtype,normalize",
                         [("uint8", True), ("float32", True),
                          ("float32", False)])
def test_get_example_equal_to_jax(synth, output_dtype, normalize):
    images_dir, ann = synth
    kw = dict(image_size=32, max_boxes=4, normalize=normalize,
              output_dtype=output_dtype, decode_backend="pil",
              indices=[3, 1, 7])
    ds = pcoco.CocoDetectionDataset(images_dir, ann, **kw)
    ref = jcoco.CocoDetectionDataset(images_dir, ann, **kw)
    assert len(ds) == len(ref) == 3
    assert ds.label_to_cat_id == ref.label_to_cat_id
    assert ds.num_classes == ref.num_classes == 6
    for i in range(len(ds)):
        _equal_examples(ds.get_example(i), ref.get_example(i))
    test = pcoco.CocoTestDataset(images_dir, None, 32,
                                 output_dtype=output_dtype,
                                 normalize=normalize)
    test_ref = jcoco.CocoTestDataset(images_dir, None, 32,
                                     output_dtype=output_dtype,
                                     normalize=normalize,
                                     decode_backend="pil")
    assert test.image_ids == test_ref.image_ids
    _equal_examples(test.get_example(4), test_ref.get_example(4))


def test_unported_decode_backends_raise(synth, monkeypatch):
    """'auto' and 'cv2', once unported and raising: 'auto' resolves once
    to native, then cv2, then Pillow, and names what it resolved to; 'cv2'
    decodes as the JAX package's cv2 path, bit for bit, and raises where
    cv2 does not import; an unknown backend raises."""
    images_dir, ann = synth
    path = os.path.join(images_dir, sorted(os.listdir(images_dir))[0])
    ds = pcoco.CocoDetectionDataset(images_dir, ann, decode_backend="auto")
    assert ds.backend == pcoco.resolved_decode_backend() == "native"
    assert pcoco.CocoTestDataset(images_dir,
                                 decode_backend="auto").backend == "native"
    np.testing.assert_array_equal(pcoco.decode_cv2(path, 32),
                                  jcoco._decode_fast(path, 32))
    cv2_ds = pcoco.CocoDetectionDataset(images_dir, ann, 32,
                                        decode_backend="cv2")
    np.testing.assert_array_equal(
        cv2_ds.get_example(0)["images"],
        jcoco.CocoDetectionDataset(images_dir, ann, 32,
                                   decode_backend="cv2").get_example(0)[
                                       "images"])

    def no_build():
        raise RuntimeError("g++ failed to build jpeg_decode.cc:\nno jpeglib.h")

    monkeypatch.setattr(pcoco, "_resolved", None)
    monkeypatch.setattr(native_decode, "get_lib", no_build)
    assert pcoco.resolved_decode_backend() == "cv2"
    monkeypatch.setattr(pcoco, "_resolved", None)
    monkeypatch.setattr(pcoco, "_cv2_module", False)
    assert pcoco.CocoDetectionDataset(images_dir, ann,
                                      decode_backend="auto").backend == "pil"
    with pytest.raises(ImportError, match="cv2"):
        pcoco.CocoDetectionDataset(images_dir, ann, decode_backend="cv2")
    with pytest.raises(ImportError, match="cv2"):
        pcoco.CocoTestDataset(images_dir, decode_backend="cv2")
    with pytest.raises(ValueError, match="decode_backend"):
        pcoco.CocoTestDataset(images_dir, decode_backend="turbo")


def test_shuffled_order_bit_equal():
    for n, seed, epoch in ((10, 0, 0), (37, 42, 3), (1000, 7, 11)):
        np.testing.assert_array_equal(
            ploader.shuffled_order(n, seed, epoch),
            jloader.shuffled_order(n, seed, epoch))
    np.testing.assert_array_equal(ploader.shuffled_order(5, 1, 1, False),
                                  np.arange(5))


def test_loader_batches_and_order_equal_to_jax_two_epochs(synth):
    images_dir, ann = synth
    kw = dict(image_size=32, max_boxes=4, output_dtype="uint8",
              decode_backend="pil")
    ds = pcoco.CocoDetectionDataset(images_dir, ann, **kw)
    ref = jcoco.CocoDetectionDataset(images_dir, ann, **kw)
    for drop_last in (True, False):
        lo = ploader.DataLoader(ds, 4, shuffle=True, seed=5,
                                drop_last=drop_last, num_workers=3)
        lr = jloader.DataLoader(ref, 4, shuffle=True, seed=5,
                                drop_last=drop_last, num_workers=3)
        assert len(lo) == len(lr) == (2 if drop_last else 3)
        for epoch in (0, 1):
            lo.set_epoch(epoch)
            lr.set_epoch(epoch)
            got, want = list(lo), list(lr)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _equal_examples(a, b)


def test_loader_surfaces_a_dataset_error():
    class Broken:
        def __len__(self):
            return 4

        def get_example(self, i):
            raise OSError(f"cannot decode {i}")

    with pytest.raises(OSError, match="cannot decode"):
        list(ploader.DataLoader(Broken(), 2))


def test_pad_batch():
    batch = {"images": np.ones((3, 2, 2, 3), np.uint8),
             "valid": np.ones((3, 4), bool),
             "image_id": np.arange(3, dtype=np.int64)}
    out = ploader.pad_batch(batch, 5)
    ref = jloader.pad_batch(batch, 5)
    _equal_examples(out, ref)
    assert out["images"].shape[0] == 5 and not out["valid"][3:].any()
    assert ploader.pad_batch(batch, 3) is batch


def test_device_prefetch_on_cpu_keeps_order_keys_and_errors(synth):
    images_dir, ann = synth
    ds = pcoco.CocoDetectionDataset(images_dir, ann, image_size=32,
                                    max_boxes=4, output_dtype="uint8")
    loader = ploader.DataLoader(ds, 3, shuffle=False)
    got = list(ploader.device_prefetch(
        iter(loader), "cpu", device_keys=("images", "valid"),
        transform=lambda b: ploader.pad_batch(b, 3)))
    want = list(loader)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.is_tensor(g["images"]) and torch.is_tensor(g["valid"])
        assert isinstance(g["image_id"], np.ndarray)
        np.testing.assert_array_equal(g["images"].numpy()[:len(w["images"])],
                                      w["images"])

    def broken():
        yield {"images": np.zeros((1, 2), np.uint8)}
        raise ValueError("loader failed")

    with pytest.raises(ValueError, match="loader failed"):
        list(ploader.device_prefetch(broken(), "cpu"))


@pytest.fixture(scope="module")
def jax_packed(synth, tmp_path_factory):
    images_dir, ann = synth
    src = jcoco.CocoDetectionDataset(images_dir, ann, image_size=32,
                                     max_boxes=5, output_dtype="uint8",
                                     decode_backend="pil")
    out = str(tmp_path_factory.mktemp("jpacked"))
    return jpacked.pack_dataset(src, out, num_workers=2), src


def test_port_reads_a_jax_packed_directory(jax_packed):
    path, _ = jax_packed
    for kw in (dict(), dict(indices=[9, 0, 4], max_boxes=3),
               dict(output_dtype="float32", max_boxes=7, image_size=32)):
        ds = ppacked.PackedDataset(path, **kw)
        ref = jpacked.PackedDataset(path, **kw)
        assert len(ds) == len(ref)
        assert ds.label_to_cat_id == ref.label_to_cat_id
        assert ds.image_ids == ref.image_ids
        assert ds.coco_path == ref.coco_path
        _equal_examples(ds.get_batch([2, 0, 1]), ref.get_batch([2, 0, 1]))
        _equal_examples(ds.get_example(1), ref.get_example(1))
    with pytest.raises(ValueError, match="image_size"):
        ppacked.PackedDataset(path, image_size=64)


def test_port_pack_equals_jax_pack(jax_packed, tmp_path):
    """The port's packer writes the JAX packer's files, so either package
    reads the other's directory."""
    path, src = jax_packed
    images_dir = src.images_dir
    ds = pcoco.CocoDetectionDataset(images_dir, src.coco_path,
                                    image_size=32, max_boxes=5,
                                    output_dtype="uint8")
    out = ppacked.pack_dataset(ds, str(tmp_path / "p"), num_workers=2,
                               flush_every=3)
    for name in ("images.u8.npy", "boxes.npy", "labels.npy", "valid.npy",
                 "image_ids.npy", "orig_sizes.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(out, name)),
                                      np.load(os.path.join(path, name)))
    with open(os.path.join(out, "meta.json")) as a, open(
            os.path.join(path, "meta.json")) as b:
        assert json.load(a) == json.load(b)
    loader = ploader.DataLoader(ppacked.PackedDataset(out), 4, shuffle=True,
                                seed=1)
    ref = jloader.DataLoader(jpacked.PackedDataset(out), 4, shuffle=True,
                             seed=1)
    for a, b in zip(loader, ref):
        _equal_examples(a, b)
    with pytest.raises(ValueError, match="uint8"):
        ppacked.pack_dataset(pcoco.CocoDetectionDataset(
            images_dir, src.coco_path, image_size=32), str(tmp_path / "f"))
