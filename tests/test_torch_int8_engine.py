"""``ServingEngine(int8_decoder=True, int8_unet=True)`` against the JAX
package's int8 engine on the CPU at tiny widths in fp32: warm restores with
dynamic scales, ``calibrate_int8`` (each conv's static scale against
JAX's), calibrated warm and cold restores, and the engine over
``devices=["cpu", "cpu"]``.

JAX's side runs its engine's own functions (``_restore_impl``,
``with_int8_records``, ``apply_int8_calibration`` as ``calibrate_int8``
composes them) eagerly, so that each int8 conv's quantized input can be
recorded in call order; the noise is JAX's, redrawn with its own key
splitting and injected (``calibrate_int8`` hands its forward one key where
``restore`` hands per-sample keys, and the port is given what each draws).

Why the outputs are compared with JAX's quantized activations injected:
an int8 conv rounds its input to a grid, so an fp32 difference of one ulp
(the two packages' convs, norms and attention sum in other orders: the fp
engines agree to ~5e-6 here) moves an element across a rounding boundary
now and then: one quantum, a change of 1/127 of the sample's largest
activation. A random-weight network then spreads it, and every later
quantization turns the spread into more flips (``test_first_difference_is_
a_one_quantum_flip`` shows it: the first differing input is one quantum
apart at a few entries, its scale within 1e-5 of JAX's). So the outputs are held
to JAX's (1e-4 max-abs, fp32 reassociation on the ~5e-6 the fp engines
show) with each int8 conv fed JAX's integers and scale, while the port's
own quantized input is checked against JAX's at every conv: at most one
quantum apart, at no more than 0.1% of the entries, the scales at 1e-5
relative. Calibrated scales per conv path: 1e-5 relative.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.inference import serving as jserving
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.ops import primitives as jp
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.ops import primitives as tp

from test_torch_cold import _pre, cond_draws, engine_noise, jax_draws, statics_pair
from test_torch_serving import random_tree

J_STATICS, T_STATICS = statics_pair(use_adain=True, train_input=False)
B, N = 2, 2
IDS = np.array([1, 0])
OUT_ATOL = 1e-4
FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (as ``tests/test_torch_serving.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def accelerator_subpixel_mode():
    """JAX folds upsamplers only under subpixel mode "3", its accelerators'
    default; the port always folds (``tests/test_torch_int8.py``)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jp, "_SUBPIXEL_UP", "3")
        yield


@contextlib.contextmanager
def jax_records():
    """Each int8 conv of JAX's eager forwards in the block: (x int8, scale)."""
    rec = []
    orig = jp._quantize_act_int8

    def wrapped(p, x):
        x8, s = orig(p, x)
        rec.append((np.asarray(x8), np.asarray(s)))
        return x8, s

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jp, "_quantize_act_int8", wrapped)
        yield rec


@contextlib.contextmanager
def fed(rec):
    """The port's int8 convs quantize their own input (records included),
    are checked against JAX's ``rec`` in call order, then take JAX's
    integers and scale. Yields the per-conv (max |dq|, flips, size, scale
    relative difference)."""
    stats, it = [], iter(rec)
    orig = tp._quantize_act_int8

    def wrapped(p, x):
        x8, s = orig(p, x)
        jx8, js = next(it)
        jx8, js = np.array(jx8), np.array(js)
        d = (x8.long() - torch.from_numpy(jx8).long()).abs()
        assert s.shape == js.shape
        rel = float(np.abs(s.numpy() - js).max() / np.abs(js).max())
        stats.append((int(d.max()), int((d != 0).sum()), d.numel(), rel))
        return torch.from_numpy(jx8), torch.from_numpy(js)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tp, "_quantize_act_int8", wrapped)
        yield stats
    assert next(it, None) is None, "the port ran fewer int8 convs than JAX"


def check_quanta(stats):
    assert stats
    assert max(s[0] for s in stats) <= 1
    assert sum(s[1] for s in stats) <= FLIP_SHARE * sum(s[2] for s in stats)
    assert max(s[3] for s in stats) <= SCALE_RTOL


def _a_scales(tree, path=""):
    out = {}
    if isinstance(tree, dict):
        if "a_scale" in tree:
            out[path] = np.asarray(tree["a_scale"]).item()
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out.update(_a_scales(v, f"{path}.{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_a_scales(v, f"{path}.{i}"))
    return out


@pytest.fixture(scope="module")
def engines(accelerator_subpixel_mode):
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    # both engines from JAX's merged bundle: the quantizers then see the same
    # fp32 kernels (the packages' LoRA merges differ in the last bit)
    jbundle = jrest.serving_bundle(params, J_STATICS)
    tbundle = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jbundle))
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8)
    refs = rng.integers(0, 256, (B, N, 128, 128, 3), dtype=np.uint8)
    jeng = jserving.ServingEngine(jbundle, J_STATICS, use_fused_attention=False,
                                  int8_decoder=True, int8_unet=True)
    teng = ServingEngine(tbundle, T_STATICS, device="cpu", int8_decoder=True, int8_unet=True)
    onboard_rng = jax.random.PRNGKey(31)
    jeng.onboard(jnp.asarray(refs), onboard_rng)
    onboard_noise = engine_noise([cond_draws(k, 1, N) for k in jax.random.split(onboard_rng, B)])
    teng.onboard(torch.from_numpy(refs), noise=onboard_noise)
    return dict(jeng=jeng, teng=teng, tbundle=tbundle,
                images=images, refs=refs, onboard_noise=onboard_noise)


def jax_warm(jeng, params, images, rng):
    """JAX's engine restore, eager, with its int8 records."""
    keys = jserving._per_sample_keys(rng, B)
    with jax_records() as rec:
        out = jeng._restore_impl(params, jnp.asarray(images), jeng.kv_cache, jnp.asarray(IDS), keys)
    return np.asarray(out), rec, jax_draws(keys, B)


def test_int8_weights_equal_jax_engines(engines):
    """Every int8 weight and folded kernel of the two engines' bundles, bit
    for bit; the capture networks and the encoder stay fp32."""
    jeng, teng = engines["jeng"], engines["teng"]
    got = convert.to_jax_tree(teng.params)
    count = [0]

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                if k in ("kernel_int8", "kernel_scale", "calib_slot"):
                    np.testing.assert_array_equal(b[k], np.asarray(a[k]))
                    count[0] += k == "kernel_int8"
                elif isinstance(a[k], (dict, list)):
                    walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)

    walk(jeng.params, got)
    assert count[0] == 95
    assert "weight_int8" not in str(convert.state_dict(teng.params["original_unet"]).keys())
    assert "weight" in teng.params["vae"]["encoder"]["down_blocks"][0]["resnets"][0]["conv1"]
    for layer, (k, v) in zip(teng.kv_cache, jeng.kv_cache):
        np.testing.assert_allclose(layer.rk.numpy(), np.asarray(k), rtol=1e-4, atol=1e-4)


def test_dynamic_restore_matches_jax(engines):
    jeng, teng = engines["jeng"], engines["teng"]
    want, rec, draws = jax_warm(jeng, jeng.params, engines["images"], jax.random.PRNGKey(32))
    with fed(rec) as stats:
        got = teng.restore(torch.from_numpy(engines["images"]), torch.from_numpy(IDS),
                           noise=draws).numpy()
    assert len(stats) == 95 and all(s[3] <= SCALE_RTOL for s in stats)
    check_quanta(stats)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)


def test_first_difference_is_a_one_quantum_flip(engines):
    """Without JAX's integers fed in, the port's quantized inputs equal
    JAX's conv by conv up to the first that differs; there one quantum
    apart at a few entries (at most 4, or 0.1% of a large input), its scale
    within 1e-5 relative of JAX's. Later convs differ more (see the module docstring);
    the images stay within bench.py's max-abs gate of each other."""
    jeng, teng = engines["jeng"], engines["teng"]
    want, rec, draws = jax_warm(jeng, jeng.params, engines["images"], jax.random.PRNGKey(32))
    mine = []
    orig = tp._quantize_act_int8

    def recording(p, x):
        x8, s = orig(p, x)
        mine.append((x8.numpy().copy(), s.numpy().copy()))
        return x8, s

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tp, "_quantize_act_int8", recording)
        got = teng.restore(torch.from_numpy(engines["images"]), torch.from_numpy(IDS),
                           noise=draws).numpy()
    assert len(mine) == len(rec)
    diffs = [int((a[0] != b[0]).sum()) for a, b in zip(mine, rec)]
    first = next((i for i, d in enumerate(diffs) if d), None)
    if first is None:  # no flip at all: the images agree as the fed ones do
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)
        return
    (x8, s), (jx8, js) = mine[first], rec[first]
    assert np.abs(x8.astype(int) - jx8.astype(int)).max() == 1
    assert diffs[first] <= max(4, FLIP_SHARE * x8.size)
    np.testing.assert_allclose(s, js, rtol=SCALE_RTOL)
    assert np.abs(got - want).max() <= 0.5


def test_calibrate_and_restore_match_jax(engines):
    """``calibrate_int8`` on one batch at margin 1.05: the number of convs
    and each conv's static scale against JAX's; then the calibrated warm
    restore."""
    jeng, teng = engines["jeng"], engines["teng"]
    images = engines["images"]
    cal_rng = jax.random.PRNGKey(33)
    with jax_records() as rec:
        _, (slots, scales) = jp.with_int8_records(jeng._restore_impl)(
            jeng.params, jnp.asarray(images), jeng.kv_cache, jnp.asarray(IDS), cal_rng)
    jparams = jp.apply_int8_calibration(jeng.params, np.asarray(slots), np.asarray(scales),
                                        margin=1.05)
    with pytest.raises(RuntimeError):
        ServingEngine(engines["tbundle"], T_STATICS, device="cpu",
                      int8_unet=True).calibrate_int8([])
    with fed(rec) as stats:
        n = teng.calibrate_int8([(torch.from_numpy(images), torch.from_numpy(IDS),
                                  jax_draws(cal_rng, B))])
    check_quanta(stats)
    assert n == len(np.unique(np.asarray(slots))) == 95
    want, got = _a_scales(jparams), _a_scales(convert.to_jax_tree(teng.params))
    assert sorted(want) == sorted(got) and len(want) == 95
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=SCALE_RTOL, err_msg=path)

    want, rec, draws = jax_warm(jeng, jparams, images, jax.random.PRNGKey(34))
    with fed(rec) as stats:
        got = teng.restore(torch.from_numpy(images), torch.from_numpy(IDS), noise=draws).numpy()
    assert all(s[3] <= SCALE_RTOL for s in stats)
    check_quanta(stats)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)

    # the cold path: fp capture networks, the calibrated int8 restore nets
    rng = jax.random.PRNGKey(35)
    keys = jserving._per_sample_keys(rng, B)
    with jax_records() as rec:
        want = np.asarray(jrest.restore_forward(
            jparams, _pre(images), _pre(engines["refs"]), rng=keys, statics=J_STATICS,
            timestep=249, use_fused_attention=False)["output_image"])
    with fed(rec) as stats:
        got = teng.restore_cold(torch.from_numpy(images), torch.from_numpy(engines["refs"]),
                                noise=jax_draws(keys, B, N)).numpy()
    assert len(stats) == 95
    check_quanta(stats)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)


def test_two_devices_equal_one_device(engines):
    """The multi-device int8 engine: each worker receives the quantized
    bundle and, after ``calibrate_int8`` (run on the first device over
    the whole batch), the calibrated scales; each device's rows then equal
    the one-device engine's restore of those rows, dynamic and calibrated,
    and the scales equal the one-device engine's. (Against the one-device
    batch of 2 the rows differ as far as one-quantum flips carry a batch
    size's other fp32 summation order: the module docstring.)"""
    bundle, images = engines["tbundle"], torch.from_numpy(engines["images"])
    ids = torch.from_numpy(IDS)
    noise = {k: torch.from_numpy(np.random.default_rng(i).normal(size=(B, 16, 16, 4))
                                 .astype(np.float32)) for i, k in enumerate(("latent", "diffusion"))}
    one = ServingEngine(bundle, T_STATICS, device="cpu", int8_decoder=True, int8_unet=True)

    def by_rows():
        return torch.cat([one.restore(images[i:i + 1], ids[i:i + 1],
                                      noise={k: v[i:i + 1] for k, v in noise.items()})
                          for i in range(B)])

    with ServingEngine(bundle, T_STATICS, devices=["cpu", "cpu"], int8_decoder=True,
                       int8_unet=True) as two:
        for eng in (one, two):
            eng.onboard(torch.from_numpy(engines["refs"]), noise=engines["onboard_noise"])
        outs = [(by_rows(), two.restore(images, ids, noise=noise))]
        batch = [(images, ids, noise)]
        assert one.calibrate_int8(batch) == two.calibrate_int8(batch) == 95
        assert _a_scales(convert.to_jax_tree(one.params)) == \
            _a_scales(convert.to_jax_tree(two.params))
        outs.append((by_rows(), two.restore(images, ids, noise=noise)))
    for a, b in outs:
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5)
    assert (outs[0][0] - outs[1][0]).abs().max() > 0  # the static scales are in use
