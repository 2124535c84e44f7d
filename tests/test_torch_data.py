"""The port's data pipeline against the JAX package's, on the same files and
seeds: the degradation chain, the training transforms, every key of
``RestoreDataset`` (landmark targets, pos/neg swaps, facial components, ID
matrices and degradation parameters on), ``RestoreDatasetTest`` and
``PairedDataset`` items, ``collate`` and the loader's batches with 0 and 2
workers. Host data is compared bit for bit."""

import dataclasses
import random

import numpy as np
import pytest
import torch
from PIL import Image

from instantrestore_tpu.data import datasets as jds
from instantrestore_tpu.data import degradations as jdeg
from instantrestore_tpu.data import loader as jloader
from instantrestore_tpu.data import transforms as jtr
from instantrestore_tpu_torch.data import datasets as tds
from instantrestore_tpu_torch.data import degradations as tdeg
from instantrestore_tpu_torch.data import loader as tloader
from instantrestore_tpu_torch.data import transforms as ttr

RES = 64
N_LANDMARKS = 640  # the dataset reads points 0, 590 and 626


def _image(rng, side):
    return Image.fromarray(rng.integers(0, 255, (side, side, 3), np.uint8))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Three training identities (one with a single image, left out) with
    landmark files, two validation identities, one debug identity."""
    root = tmp_path_factory.mktemp("torch_data")
    rng = np.random.default_rng(0)
    for name, n in (("ann", 4), ("ben", 3), ("cat", 2), ("solo", 1)):
        d = root / "train" / name
        (d / "cropped_images").mkdir(parents=True)
        (d / "new_landmarks").mkdir()
        for i in range(n):
            _image(rng, 80).save(d / "cropped_images" / f"{i:02d}.png")
            lm = rng.uniform(4, RES - 4, (N_LANDMARKS, 2)).astype(np.float32)
            np.save(d / "new_landmarks" / f"{i:02d}.npy", lm)
    for name, n_refs in (("x", 2), ("y", 1)):
        d = root / "val" / name
        (d / "conditioning").mkdir(parents=True)
        _image(rng, 72).save(d / "degraded.png")
        _image(rng, 72).save(d / "gt.png")
        for i in range(n_refs):
            _image(rng, 72).save(d / "conditioning" / f"c{i}.png")
    d = root / "debug" / "p" / "canonical_images"
    d.mkdir(parents=True)
    for i in range(3):
        _image(rng, 70).save(d / f"{i}.png")
    return root


def assert_same(a, b, path="item"):
    """Equal bit for bit, through dicts, tuples, lists and dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        assert dataclasses.asdict(a) == dataclasses.asdict(b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


ALL_ON = dict(get_gt_attn_probs=True, get_attn_pos_reg=True, get_attn_neg_reg=True,
              get_facial_comps=True, get_id_mats=True, return_degradation_params=True)


@pytest.fixture(scope="module")
def restore_pair(roots):
    kw = dict(max_conditioning_images=4, resolution=RES, seed=5, **ALL_ON)
    return (jds.RestoreDataset(roots / "train", **kw),
            tds.RestoreDataset(roots / "train", **kw))


def test_degrade_matches_jax():
    img = np.random.default_rng(1).random((RES, RES, 3)).astype(np.float32)
    for seed in range(3):
        jp = jdeg.sample_degradation_params(np.random.default_rng(seed))
        tp = tdeg.sample_degradation_params(np.random.default_rng(seed))
        assert_same(jp, tp)
        assert_same(jdeg.degrade(img, jp, resolution=RES), tdeg.degrade(img, tp, resolution=RES))
    assert_same(jdeg.degrade_at_severity(img, 0.4, seed=3, resolution=RES),
                tdeg.degrade_at_severity(img, 0.4, seed=3, resolution=RES))
    assert_same(jdeg.anisotropic_gaussian_kernel(41, 3.0, 8.0, 0.7),
                tdeg.anisotropic_gaussian_kernel(41, 3.0, 8.0, 0.7))


@pytest.mark.parametrize("which", ["train", "test", "jitter", "blur"])
def test_paired_transforms_match_jax(which):
    rng = np.random.default_rng(2)
    a, b = _image(rng, 90), _image(rng, 90)
    for seed in range(4):
        if which == "train":
            fns = jtr.PairedTrainTransform(RES), ttr.PairedTrainTransform(RES)
        elif which == "test":
            fns = jtr.PairedTestTransform(RES), ttr.PairedTestTransform(RES)
        elif which == "jitter":
            fns = jtr.PairedColorJitter(), ttr.PairedColorJitter()
        else:
            fns = jtr.PairedRandomBlur(p=0.9), ttr.PairedRandomBlur(p=0.9)
        want = fns[0](a, b, random.Random(seed))
        got = fns[1](a, b, random.Random(seed))
        for w, g in zip(want, got):
            assert_same(np.asarray(w), np.asarray(g))
    assert_same(np.asarray(jtr.resize_large_axis(a.crop((0, 0, 90, 60)), 50)),
                np.asarray(ttr.resize_large_axis(a.crop((0, 0, 90, 60)), 50)))


def test_restore_dataset_items_match_jax(restore_pair):
    jd, td = restore_pair
    assert [p.name for p in jd.paths] == [p.name for p in td.paths]
    assert len(td) == 9  # the single-image identity is left out
    seen = set()
    for idx in range(len(td)):
        want, got = jd[idx], td[idx]
        assert_same(want, got, f"item {idx}")
        seen |= {k for k, v in got.items() if v is not None}
        if got["gt_attn_probs"] is not None:
            seen.add(f"layer {got['gt_attn_probs'][2]}")
    # every optional key was exercised, and the targets took more than one layer
    assert {"gt_attn_probs", "facial_comps", "facial_comp_boxes", "id_mat", "id_valid",
            "degradation_params", "pos_reg_idx", "neg_reg_idx"} <= seen
    assert len({k for k in seen if k.startswith("layer ")}) > 1
    assert any(int(td[i]["pos_reg_idx"]) >= 0 for i in range(len(td)))


def test_item_seed_rule_is_per_index_and_name(restore_pair):
    """The same index gives the same item twice; another seed another one."""
    _, td = restore_pair
    assert_same(td[3], td[3])
    other = tds.RestoreDataset(td.identity_dirs[0].parent, resolution=RES, seed=6, **ALL_ON)
    assert not np.array_equal(other[3]["image"], td[3]["image"])


def test_test_and_paired_datasets_match_jax(roots):
    for jcls, tcls, folder in ((jds.RestoreDatasetTest, tds.RestoreDatasetTest, "val"),
                               (jds.PairedDataset, tds.PairedDataset, "debug")):
        jd = jcls(roots / folder, max_conditioning_images=4, resolution=RES)
        td = tcls(roots / folder, max_conditioning_images=4, resolution=RES)
        assert len(td) == len(jd) > 0
        for idx in range(len(td)):
            assert_same(jd[idx], td[idx], f"{folder} item {idx}")


def test_collate_matches_jax(restore_pair):
    jd, td = restore_pair
    for idx in ([0, 4, 7], [1, 2]):
        assert_same(jds.collate([jd[i] for i in idx]), tds.collate([td[i] for i in idx]))


@pytest.fixture(scope="module")
def light_pair(roots):
    """The datasets without landmark targets (the 64 x 64-token layers'
    [5, 4096, 4096] maps dominate an item's time), for the loader's order."""
    kw = dict(ALL_ON, get_gt_attn_probs=False)
    return (jds.RestoreDataset(roots / "train", resolution=RES, seed=5, **kw),
            tds.RestoreDataset(roots / "train", resolution=RES, seed=5, **kw))


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_jax(light_pair, workers):
    jd, td = light_pair
    kw = dict(shuffle=True, num_workers=workers, seed=11, drop_last=True)
    jl, tl = jloader.DataLoader(jd, 2, **kw), tloader.DataLoader(td, 2, **kw)
    assert len(jl) == len(tl) == 4
    for epoch in range(2):  # the shuffle moves with the epoch
        want, got = list(jl), list(tl)
        assert len(got) == 4
        for w, g in zip(want, got):
            assert_same(w, g, f"epoch {epoch}")


def test_loader_starts_at_a_step_and_slices_processes(light_pair):
    _, td = light_pair
    ref = tloader.DataLoader(td, 2, num_workers=0, seed=3)
    full = [b["image"] for _ in range(2) for b in ref]  # two epochs of four batches
    loader = tloader.DataLoader(td, 2, num_workers=1, seed=3)
    loader.start_at(1, 2)
    resumed = [b["image"] for b in loader]
    assert len(resumed) == 2
    for a, b in zip(resumed, full[6:]):
        np.testing.assert_array_equal(a, b)
    halves = [tloader.DataLoader(td, 4, num_workers=0, seed=3, process_index=i, process_count=2)
              for i in range(2)]
    whole = next(iter(tloader.DataLoader(td, 4, num_workers=0, seed=3)))
    parts = [next(iter(h)) for h in halves]
    np.testing.assert_array_equal(np.concatenate([p["image"] for p in parts]), whole["image"])


def test_to_torch_batch(restore_pair):
    _, td = restore_pair
    batch = tds.collate([td[i] for i in (0, 4)])
    dev, layer = tds.to_torch_batch(batch, "cpu")
    assert layer == batch["gt_attn_probs"][2]
    assert set(dev) == {k for k in tds.DEVICE_KEYS if k in batch} | {
        "gt_attn_probs", "gt_attn_mask", "gt_attn_cond"}
    assert isinstance(dev["facial_comps"], list) and len(dev["facial_comps"]) == 3
    assert set(dev["degradation_params"]) == set(batch["degradation_params"])
    for k in ("image", "gt", "conditioning_images", "id_mats_pred", "facial_comp_boxes"):
        assert isinstance(dev[k], torch.Tensor)
        np.testing.assert_array_equal(dev[k].numpy(), batch[k])
    assert dev["gt_attn_mask"].dtype == torch.bool and dev["gt_attn_cond"].dtype == torch.int32
