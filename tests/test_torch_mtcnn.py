"""The port's MTCNN cascade and canonical-face crop against the JAX
package's, on the CPU in fp32: P-, R- and O-net outputs from a
JAX-initialised tree, the copied host glue (NMS, re-rectification,
regression, crops), ``detect_faces`` boxes, scores and landmarks on a
seeded image, the two detector adapters, the facenet_pytorch converter and
``CanonicalFaceProcess`` with the cascade as its detector.

Tolerances: networks relative RMS <= 1e-5 and max-abs <= 1e-4; the
cascade's boxes and landmarks within 1e-3 px and scores within 1e-5 (the
net outputs' fp32 error, carried through box regression on a 96 px image);
host glue and crops bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.data import canonical_face as jcf
from instantrestore_tpu.data import mtcnn as jm
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.data import canonical_face as tcf
from instantrestore_tpu_torch.data import mtcnn as tm

from test_torch_id_loss import assert_net_close
from test_torch_serving import random_tree

THRESHOLDS = (0.3, 0.3, 0.3)  # random weights: low enough that faces are found
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def nets():
    jp = random_tree(jm.init_mtcnn_params, jax.random.PRNGKey(0))
    return jp, convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 255, (96, 80, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_detections(nets, image):
    return jm.detect_faces(nets[0], image, thresholds=THRESHOLDS)


def _x(seed, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("net,shape", [("pnet", (2, 40, 37, 3)), ("rnet", (5, 24, 24, 3)),
                                       ("onet", (5, 48, 48, 3))])
def test_nets_match(nets, net, shape):
    jp, tp = nets
    x = _x(1, *shape)
    want = getattr(jm, f"{net}_apply")(jp[net], jnp.asarray(x))
    got = getattr(tm, f"{net}_apply")(tp[net], torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_net_close(g, w)


def test_host_glue_equal():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (40, 2))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    for th, method in ((0.5, "union"), (0.3, "min"), (0.9, "union")):
        np.testing.assert_array_equal(tm.nms(boxes, scores, th, method),
                                      jm.nms(boxes, scores, th, method))
    reg = rng.normal(0, 0.1, (40, 4)).astype(np.float32)
    np.testing.assert_array_equal(tm._rerec(boxes), jm._rerec(boxes))
    np.testing.assert_array_equal(tm._apply_reg(boxes, reg), jm._apply_reg(boxes, reg))
    img = rng.uniform(0, 255, (50, 60, 3)).astype(np.float32)
    for size in (24, 48):
        np.testing.assert_array_equal(tm._crop_resize(img, boxes - 10, size),
                                      jm._crop_resize(img, boxes - 10, size))


def test_detect_faces_matches(nets, image, jax_detections):
    boxes, scores, points = tm.detect_faces(nets[1], image, thresholds=THRESHOLDS)
    wb, ws, wp = jax_detections
    assert len(wb) > 0 and boxes.shape == wb.shape and points.shape == wp.shape == (len(wb), 5, 2)
    np.testing.assert_allclose(boxes, wb, rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(scores, ws, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(points, wp, rtol=0, atol=BOX_ATOL)


def test_detector_adapters(nets, image, jax_detections):
    wb, ws, wp = jax_detections
    best = int(np.argmax(ws))
    np.testing.assert_allclose(tm.landmark_detector(nets[1], thresholds=THRESHOLDS)(image),
                               wp[best], rtol=0, atol=BOX_ATOL)
    det = tm.default_detector(nets[1], thresholds=THRESHOLDS)(image)
    assert isinstance(det, tcf.FaceDetection)
    np.testing.assert_allclose(det.bbox, wb[best], rtol=0, atol=BOX_ATOL)
    # a threshold no face passes: None, as in JAX
    assert tm.landmark_detector(nets[1], thresholds=(1.1, 1.1, 1.1))(image) is None


def test_convert_facenet_state_dicts(nets):
    """facenet_pytorch's PNet / RNet / ONet names (PReLU weights [C]):
    both converters give the same weights."""
    _, tp = nets
    sds = []
    for net in ("pnet", "rnet", "onet"):
        sd = {}
        for name, p in tp[net].items():
            if isinstance(p, dict):
                sd[f"{name}.weight"], sd[f"{name}.bias"] = p["weight"], p["bias"]
            else:
                sd[f"{name}.weight"] = p
        sds.append(sd)
    got = tm.convert_mtcnn_params(*sds)
    want = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jm.convert_mtcnn_params(*sds)))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


def test_canonical_face_matches(image, jax_detections):
    """CanonicalFaceProcess on the cascade's best face: the same crop and
    landmarks as the JAX package's, and the centre crop without a
    detection."""
    from PIL import Image

    wb, ws, wp = jax_detections
    best = int(np.argmax(ws))
    pil = Image.fromarray(image)
    for det in (True, False):
        got = tcf.CanonicalFaceProcess(
            (lambda a: tcf.FaceDetection(wb[best], wp[best])) if det else None, output_size=64)(pil)
        want = jcf.CanonicalFaceProcess(
            (lambda a: jcf.FaceDetection(wb[best], wp[best])) if det else None, output_size=64)(pil)
        np.testing.assert_array_equal(np.asarray(got["image"]), np.asarray(want["image"]))
        if det:
            np.testing.assert_array_equal(got["landmarks"], want["landmarks"])
        else:
            assert got["landmarks"] is None and want["landmarks"] is None
        assert got["mask"] is None and want["mask"] is None
