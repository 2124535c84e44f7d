"""The port's ArcFace ID loss against the JAX package's, on the CPU in fp32:
the copied numpy helpers (templates, cp2tform similarity, alignment and
detector-driven mats), ``warp_affine`` (values and image gradient), IR-SE-50
embeddings from a JAX-initialised tree (with seeded BatchNorm statistics so
that every affine is live), and ``id_loss`` / ``id_loss_whole_image`` with
their gradient w.r.t. the prediction.

Tolerances: networks relative RMS <= 1e-5 and max-abs <= 1e-4; losses
relative 1e-5, and 1e-6 absolute where the loss is 1 - cos of two unit
embeddings near 1 (random weights map every face close to one direction,
and cos carries fp32 rounding of ~1e-7 per term); the warp's gradient as a
network's; the losses' gradients relative RMS <= 1e-4 and max-abs <= 1e-4
of their largest entry, since the gradient of 1 - cos is the part of the
target embedding orthogonal to the prediction's, a difference of nearly
parallel unit vectors (measured 1.0e-5); the numpy helpers bit for bit (the
same code on the same inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.training.losses import id_loss as jid
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.training.losses import id_loss as tid

from test_torch_serving import random_tree

NET_REL_RMS, NET_MAX_ABS, LOSS_REL, LOSS_ATOL = 1e-5, 1e-4, 1e-5, 1e-6
LOSS_GRAD_REL_RMS = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def assert_net_close(got, want, rel_rms=NET_REL_RMS, max_abs=NET_MAX_ABS):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.sqrt(((got - want) ** 2).sum() / max((want ** 2).sum(), 1e-30))
    assert err <= rel_rms, err
    assert np.abs(got - want).max() <= max_abs * max(1.0, float(np.abs(want).max())), \
        np.abs(got - want).max()


@pytest.fixture(scope="module")
def arcface():
    jtree = random_tree(jid.init_arcface_params, jax.random.PRNGKey(0))
    return jtree, convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree))


def _faces(seed, b=2, res=128):
    return np.random.default_rng(seed).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)


def _mats(res=128):
    rng = np.random.default_rng(3)
    lms = []
    for i in range(3):
        rot = (1.1 + 0.2 * i) * np.array([[np.cos(0.1 * i), -np.sin(0.1 * i)],
                                          [np.sin(0.1 * i), np.cos(0.1 * i)]])
        lms.append(jid.ARCFACE_REFERENCE_POINTS @ rot.T + rng.uniform(0, 8, 2)
                   + rng.normal(0, 0.5, (5, 2)))
    lms[2] = None  # an image whose detection failed
    return lms


def test_numpy_helpers_equal():
    np.testing.assert_array_equal(tid.ARCFACE_REFERENCE_POINTS, jid.ARCFACE_REFERENCE_POINTS)
    np.testing.assert_array_equal(tid.ARCFACE_REFERENCE_POINTS_3, jid.ARCFACE_REFERENCE_POINTS_3)
    assert tid.IR50_BLOCKS == jid.IR50_BLOCKS
    lms = _mats()
    for lm in lms[:2]:
        for reflective in (True, False):
            np.testing.assert_array_equal(
                tid.similarity_transform(lm, jid.ARCFACE_REFERENCE_POINTS, reflective),
                jid.similarity_transform(lm, jid.ARCFACE_REFERENCE_POINTS, reflective))
    for out_size, ref in ((112, None), (96, None), (112, jid.ARCFACE_REFERENCE_POINTS_3)):
        pts = lms if ref is None else [None if lm is None else lm[[0, 1, 3]] for lm in lms]
        for a, b in zip(tid.alignment_transforms(pts, out_size, ref),
                        jid.alignment_transforms(pts, out_size, ref)):
            np.testing.assert_array_equal(a, b)
    images = _faces(4, b=3, res=64)
    detect = iter(lms * 2)
    got = tid.detector_alignment_mats(lambda u8: next(detect), _t(images))
    want = jid.detector_alignment_mats(lambda u8: next(detect), images)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_warp_affine_values_and_gradient():
    images = _faces(5)
    mats, _ = jid.alignment_transforms(_mats(), 112)
    w = np.random.default_rng(6).normal(size=(3, 112, 112, 3)).astype(np.float32)
    images = np.concatenate([images, _faces(7, b=1)])
    out, grad = jax.value_and_grad(
        lambda x: (jid.warp_affine(x, jnp.asarray(mats), 112) * w).sum())(jnp.asarray(images))
    tx = _t(images).requires_grad_()
    tout = tid.warp_affine(tx, _t(mats), 112)
    (tout * _t(w)).sum().backward()
    assert_net_close(tout, jid.warp_affine(jnp.asarray(images), jnp.asarray(mats), 112))
    assert_net_close(tx.grad, grad)


def test_tree_converts_and_back(arcface):
    jtree, ttree = arcface
    assert ttree["body"][0]["shortcut"] is None and ttree["body"][3]["shortcut"] is not None
    assert ttree["input"]["conv"]["weight"].shape == (64, 3, 3, 3)
    assert ttree["output"]["linear"]["weight"].shape == (512, 512 * 7 * 7)
    back = convert.to_jax_tree(ttree)
    flat_j = jax.tree_util.tree_leaves_with_path(jtree)
    flat_b = dict((jax.tree_util.keystr(k), v) for k, v in
                  jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for k, v in flat_j:
        np.testing.assert_array_equal(np.asarray(v), flat_b[jax.tree_util.keystr(k)])


def test_convert_reference_state_dict(arcface):
    """The reference's model_ir_se50.pth names: written from the port's
    tree, read back by both converters to the same weights."""
    _, ttree = arcface
    sd = {}

    def put(prefix, p, kind):
        if kind == "conv":
            sd[f"{prefix}.weight"] = p["weight"]
        else:
            sd.update({f"{prefix}.weight": p["weight"], f"{prefix}.bias": p["bias"],
                       f"{prefix}.running_mean": p["mean"], f"{prefix}.running_var": p["var"]})

    put("input_layer.0", ttree["input"]["conv"], "conv")
    put("input_layer.1", ttree["input"]["bn"], "bn")
    sd["input_layer.2.weight"] = ttree["input"]["prelu"]["alpha"]
    for i, bp in enumerate(ttree["body"]):
        if bp["shortcut"] is not None:
            put(f"body.{i}.shortcut_layer.0", bp["shortcut"]["conv"], "conv")
            put(f"body.{i}.shortcut_layer.1", bp["shortcut"]["bn"], "bn")
        r = bp["res"]
        put(f"body.{i}.res_layer.0", r["bn1"], "bn")
        put(f"body.{i}.res_layer.1", r["conv1"], "conv")
        sd[f"body.{i}.res_layer.2.weight"] = r["prelu"]["alpha"]
        put(f"body.{i}.res_layer.3", r["conv2"], "conv")
        put(f"body.{i}.res_layer.4", r["bn2"], "bn")
        put(f"body.{i}.res_layer.5.fc1", r["se"]["fc1"], "conv")
        put(f"body.{i}.res_layer.5.fc2", r["se"]["fc2"], "conv")
    put("output_layer.0", ttree["output"]["bn2d"], "bn")
    sd["output_layer.3.weight"] = ttree["output"]["linear"]["weight"]
    sd["output_layer.3.bias"] = ttree["output"]["linear"]["bias"]
    put("output_layer.4", ttree["output"]["bn1d"], "bn")
    got = tid.convert_arcface_params(sd)
    want = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jid.convert_arcface_params(sd)))
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves_with_path(want)):
        assert ka == kb
        assert torch.equal(a, b), ka


@pytest.fixture(scope="module")
def jax_side(arcface):
    """JAX's embeddings and both losses with their gradients, computed once."""
    jtree, _ = arcface
    pred, target = _faces(8), _faces(9)
    crops = np.random.default_rng(10).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    mats, valid = jid.alignment_transforms(_mats()[1:], 112)
    tmats, _ = jid.alignment_transforms(_mats()[:2], 112)
    emb = jax.jit(jid.arcface_apply)(jtree, jnp.asarray(crops))
    aligned = jax.jit(jax.value_and_grad(
        lambda p: jid.id_loss(jtree, p, jnp.asarray(target), jnp.asarray(mats),
                              jnp.asarray(tmats), jnp.asarray(valid)), has_aux=True))(
        jnp.asarray(pred))
    whole = jax.jit(jax.value_and_grad(
        lambda p: jid.id_loss_whole_image(jtree, p, jnp.asarray(target)), has_aux=True))(
        jnp.asarray(pred))
    return dict(pred=pred, target=target, crops=crops, mats=mats, tmats=tmats, valid=valid,
                emb=emb, aligned=aligned, whole=whole)


def test_arcface_embeddings_match(arcface, jax_side):
    _, ttree = arcface
    got = tid.arcface_apply(ttree, _t(jax_side["crops"]))
    assert_net_close(got, jax_side["emb"])
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("kind", ["aligned", "whole"])
def test_id_loss_and_gradient_match(arcface, jax_side, kind):
    _, ttree = arcface
    s = jax_side
    pred = _t(s["pred"]).requires_grad_()
    if kind == "aligned":
        loss, sim = tid.id_loss(ttree, pred, _t(s["target"]), _t(s["mats"]), _t(s["tmats"]),
                                torch.from_numpy(s["valid"]))
    else:
        loss, sim = tid.id_loss_whole_image(ttree, pred, _t(s["target"]))
    (want_loss, want_sim), want_grad = s[kind]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_REL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(float(sim), float(want_sim), rtol=LOSS_REL)
    assert_net_close(pred.grad, want_grad, rel_rms=LOSS_GRAD_REL_RMS)
    if kind == "aligned":  # the sample whose detection failed gets no gradient
        assert not s["valid"][1] and float(pred.grad[1].abs().max()) == 0.0


def test_all_invalid_batch_gives_zero(arcface):
    _, ttree = arcface
    x = _t(_faces(11))
    loss, sim = tid.id_loss(ttree, x, x, torch.eye(2, 3).expand(2, 2, 3), torch.eye(2, 3)
                            .expand(2, 2, 3), torch.zeros(2, dtype=torch.bool))
    assert float(loss) == 0.0 and float(sim) == 0.0
