"""The port's training loader against the JAX package's, on the CPU.

Two epochs of ``BatchLoader(shuffle=True, seed, drop_last=True)`` over a
small DOTA-format set (PNGs written with cv2 and their BGR ``.npy``
sidecars; two non-square images, letterboxed), shard 0 and 1 of 2, with
fliplr 0.5, flipud 0.5, the 90-degree rotations, the HSV jitter and
mixup: boxes, classes, masks, paths and shapes equal the JAX loader's
exactly, and the port's uint8 images times float32(1/255), as the train
step scales them on the device, equal the JAX loader's float32 images
exactly. The per-batch generator is the JAX one, so a batch is the same
whichever thread loads it.
"""

import numpy as np
import pytest
import torch

from s2anet_tpu.data import dota as jax_dota
from s2anet_tpu_torch.data import dota
from s2anet_tpu_torch.train.step import scale_images, to_device

from test_torch_port_data import make_dota_set

SIZE = 64
SHAPES = [(64, 64)] * 4 + [(40, 64), (64, 48)] + [(64, 64)] * 4
AUG = dict(augment=True, fliplr=0.5, flipud=0.5, rot90=True, hsv=(0.015, 0.7, 0.4))


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    return make_dota_set(tmp_path_factory.mktemp("train"), np.random.default_rng(5),
                         shapes=SHAPES, n_obj=3)


def _loaders(root, shard, workers, mixup=0.0, seed=7):
    kw = dict(shuffle=True, seed=seed, shard=shard, num_shards=2, drop_last=True,
              num_workers=workers)
    port = dota.BatchLoader(dota.DotaDataset(root / "images", img_size=SIZE, max_gt=8,
                                             mixup=mixup, **AUG), 2, **kw)
    ref = jax_dota.BatchLoader(
        jax_dota.DotaDataset(root / "images", img_size=SIZE, max_gt=8, cache_images="disk",
                             mixup=mixup, **AUG), 2, **kw)
    return port, ref


@pytest.mark.parametrize("shard,workers,mixup", [(0, 1, 0.0), (1, 3, 0.0), (0, 2, 0.5)])
def test_augmented_epochs_equal_jax(train_set, shard, workers, mixup):
    port, ref = _loaders(train_set, shard, workers, mixup)
    assert len(port) == len(ref) == 2
    seen = []
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for key in ("gt_boxes", "gt_classes", "gt_mask"):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            for key in ("paths", "orig_shapes", "img_shapes"):
                assert g[key] == w[key], key
            assert g["imgs"].dtype == np.uint8
            scaled = scale_images(torch.from_numpy(g["imgs"]), torch.float32)
            np.testing.assert_array_equal(scaled.permute(0, 2, 3, 1).numpy(), w["imgs"])
            seen.append(tuple(g["paths"]))
    # the epochs are shuffled differently, and the augmentation did something
    assert seen[:2] != seen[2:]
    assert any(g["gt_mask"].any() for g in got)


def test_shards_split_the_epoch(train_set):
    (p0, _), (p1, _) = _loaders(train_set, 0, 1), _loaders(train_set, 1, 1)
    a = [p for b in p0 for p in b["paths"]]
    b = [p for b in p1 for p in b["paths"]]
    assert len(a) == len(b) == 4 and not set(a) & set(b)


def test_to_device_scales_uint8_like_the_jax_host(train_set):
    """The step's input from a uint8 batch equals the JAX step's input from
    the JAX loader's float32 batch, bit for bit, in float32 and bfloat16."""
    port, ref = _loaders(train_set, 0, 1)
    g, w = next(iter(port)), next(iter(ref))
    for dtype in (torch.float32, torch.bfloat16):
        t = to_device(g, "cpu", dtype)
        want = torch.from_numpy(w["imgs"]).to(dtype).permute(0, 3, 1, 2)
        assert torch.equal(t["imgs"], want)
        assert t["imgs"].is_contiguous(memory_format=torch.channels_last)
