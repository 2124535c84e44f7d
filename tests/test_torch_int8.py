"""int8 serving's building blocks: the port's int8 block of
``ops/primitives.py`` (quantizers, the int8 conv and folded-upsampler route
on ``torch._int_mm``, calibration slots, records and static scales), the
decoder and UNet quantizers, and the converter on int8 trees, against the
JAX package on the CPU.

Tolerances: int8 weights and scales bit for bit against JAX's; each int8
conv's int32 products exactly against a float64 ``F.conv2d`` of the same
integers (|sum| <= 127^2 * 9 * Cin stays far below 2^53, and below 2^24 at
these widths, so fp32 holds them exactly too); the dequantized outputs
against JAX's ``conv2d`` / ``upsample2x_conv`` in fp32 at 1e-6 relative
(the same integers, then the same fp32 epilogue: they agree bit for bit
here, the tolerance only admits another rounding order of the dequantize).
The seven cases of ``tests/test_int8_calibration.py`` are ported with their
own tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instantrestore_tpu.models import unet as junet
from instantrestore_tpu.models import vae as jvae
from instantrestore_tpu.ops import primitives as jp
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference import workers as tworkers
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models import vae as tvae
from instantrestore_tpu_torch.ops import primitives as tp

from test_torch_serving import random_tree

OUT_RTOL = 1e-6


def _jconv(rng, cin, cout, k):
    return {"kernel": (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32),
            "bias": (rng.normal(size=(cout,)) * 0.01).astype(np.float32)}


def _tconv(p):
    return convert.from_jax_tree(p)


def _int8_hwio(q):
    """The port's int8 kernel laid out as JAX's ``kernel_int8``."""
    w = q["weight_int8"]
    return (tp.folded_kernel(w) if w.ndim == 5 else w.permute(1, 2, 3, 0)).numpy()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (as ``tests/test_torch_serving.py``): beside the
    other test workers, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def accelerator_subpixel_mode(monkeypatch):
    """JAX's quantizer folds upsamplers only under its accelerator default,
    subpixel mode "3" (``ops/primitives.py::_subpixel_mode``); the port
    always folds. Its docstring names this override."""
    monkeypatch.setattr(jp, "_SUBPIXEL_UP", "3")


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k, fold", [(3, False), (1, False), (3, True)])
def test_quantize_conv_matches_jax(k, fold):
    p = _jconv(np.random.default_rng(k + 10 * fold), 8, 16, k)
    jq = jp.quantize_conv_int8(jax.tree_util.tree_map(jnp.asarray, p), fold_upsample=fold)
    tq = tp.quantize_conv_int8(_tconv(p), fold_upsample=fold)
    assert tq["weight_int8"].dtype == torch.int8
    assert tq["weight_int8"].ndim == (5 if fold else 4)
    np.testing.assert_array_equal(_int8_hwio(tq), np.asarray(jq["kernel_int8"]))
    np.testing.assert_array_equal(tq["kernel_scale"].numpy(), np.asarray(jq["kernel_scale"]))
    np.testing.assert_array_equal(tq["bias"].numpy(), np.asarray(jq["bias"]))
    assert "weight" not in tq


def test_quantize_conv_refuses_lora():
    p = _tconv(_jconv(np.random.default_rng(0), 8, 16, 3))
    p = tp.add_lora(p, torch.Generator().manual_seed(0), 2, b_std=1e-3)
    with pytest.raises(ValueError, match="merge LoRA"):
        tp.quantize_conv_int8(p)


def test_phase_kernel_round_trips_and_zero_taps():
    k4 = torch.randint(-127, 128, (4, 4, 5, 7), dtype=torch.int8)
    w = tp.phase_kernel(k4)
    assert w.shape == (4, 7, 3, 3, 5)
    assert torch.equal(tp.folded_kernel(w), k4)
    # each phase reads a 2x2 window of the 3x3: 4 of 9 taps, the rest zero
    assert int((w != 0).any(dim=(1, 4)).sum()) <= 16
    assert not w[0, :, 2].any() and not w[3, :, 0].any()


def _decoder_and_unet_trees():
    ucfg = junet.UNetConfig(sample_size=16, block_out_channels=(32, 64, 64, 64),
                            attention_heads=(1, 2, 2, 2), cross_attention_dim=16,
                            norm_num_groups=8)
    vcfg = jvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4)
    unet = random_tree(junet.init_unet_params, jax.random.PRNGKey(0), ucfg, seed=1)
    vae = random_tree(jvae.init_vae_params, jax.random.PRNGKey(0), vcfg, seed=2)
    return unet, vae


def _int8_leaves(tree, path=""):
    """{path: (kernel_int8, kernel_scale)} of a JAX-layout tree."""
    out = {}
    if isinstance(tree, dict):
        if "kernel_int8" in tree:
            return {path: (np.asarray(tree["kernel_int8"]), np.asarray(tree["kernel_scale"]))}
        for k, v in tree.items():
            out.update(_int8_leaves(v, f"{path}.{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_int8_leaves(v, f"{path}.{i}"))
    return out


def test_decoder_and_unet_quantizers_match_jax():
    """Which convs are quantized (the decoder's mid and up blocks; the
    UNet's down, mid and up blocks), their int8 weights, folded
    upsamplers and scales: bit for bit."""
    unet, vae = _decoder_and_unet_trees()
    jq_unet, jq_vae = junet.quantize_unet_int8(unet), jvae.quantize_decoder_int8(vae)
    tq_unet = tunet.quantize_unet_int8(convert.from_jax_tree(jax.tree_util.tree_map(np.asarray,
                                                                                     unet)))
    tq_vae = tvae.quantize_decoder_int8(convert.from_jax_tree(jax.tree_util.tree_map(np.asarray,
                                                                                      vae)))
    for jq, tq in ((jq_unet, tq_unet), (jq_vae, tq_vae)):
        want, got = _int8_leaves(jq), _int8_leaves(convert.to_jax_tree(tq))
        assert want and sorted(want) == sorted(got)
        for path in want:
            np.testing.assert_array_equal(got[path][0], want[path][0], err_msg=path)
            np.testing.assert_array_equal(got[path][1], want[path][1], err_msg=path)
    folded = [p for p, (k, _) in _int8_leaves(jq_vae).items() if k.shape[0] == 4]
    assert len(folded) == 3 and all("upsamplers" in p for p in folded)
    assert all(".encoder" not in p and "conv_in" not in p and "conv_out" not in p
               for p in _int8_leaves(jq_vae))
    assert "weight" in tq_vae["decoder"]["conv_in"] and "weight" in tq_unet["conv_out"]


# ---------------------------------------------------------------------------
# the int8 conv route
# ---------------------------------------------------------------------------

CONV_CASES = {  # name: (cin, cout, k, stride, padding, spatial)
    "3x3": (16, 24, 3, 1, 1, 9),
    "3x3 stride 2": (16, 24, 3, 2, 1, 8),
    "1x1 shortcut": (24, 16, 1, 1, 0, 7),
    # channel counts whose columns are copied 4 and 1 bytes at a time
    "3x3, 12 channels": (12, 8, 3, 1, 1, 6),
    "3x3, 3 channels": (3, 8, 3, 2, 1, 7),
}


def _witness(x8, w_oihw, stride, padding):
    """float64 conv of the integers: exact."""
    y = F.conv2d(x8.double().permute(0, 3, 1, 2), w_oihw.double(), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_products_are_exact(case, monkeypatch):
    """Unit scales and no bias: the output is the int32 product itself. A
    tiny chunk budget (several samples and output-row chunks) gives the
    same bits."""
    cin, cout, k, stride, pad, hw = CONV_CASES[case]
    g = torch.Generator().manual_seed(3)
    x8 = torch.randint(-127, 128, (3, hw, hw, cin), generator=g)
    w8 = torch.randint(-127, 128, (cout, k, k, cin), generator=g, dtype=torch.int8)
    p = {"weight_int8": w8, "kernel_scale": torch.ones(cout),
         "a_scale": torch.tensor(1.0)}
    got = tp.conv2d(p, x8.float(), stride=stride, padding=pad)
    want = _witness(x8, w8.permute(0, 3, 1, 2), stride, pad)
    assert got.shape == want.shape
    assert torch.equal(got.double(), want)
    monkeypatch.setattr(tp, "INT8_CHUNK_BYTES", 300)
    assert torch.equal(tp.conv2d(p, x8.float(), stride=stride, padding=pad), got)


def test_folded_upsampler_products_are_exact(monkeypatch):
    """The phase product on the low-resolution grid against the JAX
    package's formulation (a 4x4 conv of the zero-inserted grid padded by
    2), both in float64 on the integers."""
    g = torch.Generator().manual_seed(4)
    x8 = torch.randint(-127, 128, (2, 5, 6, 8), generator=g)
    k4 = torch.randint(-127, 128, (4, 4, 8, 16), generator=g, dtype=torch.int8)
    p = {"weight_int8": tp.phase_kernel(k4), "kernel_scale": torch.ones(16),
         "a_scale": torch.tensor(1.0)}
    got = tp.upsample2x_conv(p, x8.float())
    xd = torch.zeros((2, 9, 11, 8), dtype=torch.float64)
    xd[:, ::2, ::2] = x8.double()
    want = F.conv2d(xd.permute(0, 3, 1, 2), k4.permute(3, 2, 0, 1).double(),
                    padding=2).permute(0, 2, 3, 1)
    assert got.shape == (2, 10, 12, 16)
    assert torch.equal(got.double(), want)
    monkeypatch.setattr(tp, "INT8_CHUNK_BYTES", 500)
    assert torch.equal(tp.upsample2x_conv(p, x8.float()), got)


@pytest.mark.parametrize("case", list(CONV_CASES) + ["folded upsampler", "unfolded upsampler"])
@pytest.mark.parametrize("static", [False, True])
def test_int8_conv_matches_jax(case, static):
    """Dequantized outputs, dynamic per-sample and static scales, against
    JAX's int8 branches on the same fp32 input."""
    rng = np.random.default_rng(5)
    if case in CONV_CASES:
        cin, cout, k, stride, pad, hw = CONV_CASES[case]
    else:
        cin, cout, k, stride, pad, hw = 8, 8, 3, 1, 1, 6
    p = _jconv(rng, cin, cout, k)
    fold = case == "folded upsampler"
    jq = jp.quantize_conv_int8(jax.tree_util.tree_map(jnp.asarray, p), fold_upsample=fold)
    tq = tp.quantize_conv_int8(_tconv(p), fold_upsample=fold)
    if static:
        jq = {**jq, "a_scale": jnp.float32(0.021)}
        tq = {**tq, "a_scale": torch.tensor(0.021)}
    x = (rng.normal(size=(2, hw, hw, cin)) * 1.5).astype(np.float32)
    if "upsampler" in case:
        want = jp.upsample2x_conv(jq, jnp.asarray(x))
        got = tp.upsample2x_conv(tq, torch.from_numpy(x))
    else:
        want = jp.conv2d(jq, jnp.asarray(x), stride=stride, padding=pad)
        got = tp.conv2d(tq, torch.from_numpy(x), stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_RTOL, atol=0)


def test_dynamic_scale_is_per_sample_and_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0, 3.49]).reshape(1, 1, 6, 1)
    x8, s = tp._quantize_act_int8({}, torch.cat([x, 2 * x]))
    assert s.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(s.flatten().numpy(), [1.0, 2.0])
    assert x8[0].flatten().tolist() == [0, 2, 2, 0, 127, 3]  # half to even, as jnp.round
    assert torch.equal(x8[0], x8[1])
    x8, _ = tp._quantize_act_int8({"a_scale": torch.tensor(0.5)}, x)
    assert x8.flatten().tolist() == [1, 3, 5, -1, 127, 7]  # clipped at 127
    assert tp._quantize_act_int8({}, torch.zeros(1, 2, 2, 1))[1].item() == pytest.approx(1e-12)


# ---------------------------------------------------------------------------
# the seven cases of tests/test_int8_calibration.py
# ---------------------------------------------------------------------------


def _conv_params(seed, cin=8, cout=16):
    g = torch.Generator().manual_seed(seed)
    return {"weight": torch.randn((cout, cin, 3, 3), generator=g) * 0.1,
            "bias": torch.randn((cout,), generator=g) * 0.01}


def _x(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_records_collected():
    p = tp.assign_calib_slots(tp.quantize_conv_int8(_conv_params(0)))
    assert int(p["calib_slot"]) == 0 and p["calib_slot"].dtype == torch.int32
    x = _x(1, (2, 8, 8, 8))
    _, (slots, scales) = tp.with_int8_records(lambda p, x: tp.conv2d(p, x))(p, x)
    assert slots.shape == (1,) and scales.shape == (1,)
    assert np.isclose(float(scales[0]), float(x.abs().max() / 127.0), rtol=1e-6)


def test_no_records_without_int8_or_slots():
    x = _x(1, (2, 8, 8, 8))
    p_fp = _conv_params(0)
    _, (slots, _) = tp.with_int8_records(lambda p, x: tp.conv2d(p, x))(p_fp, x)
    assert slots.shape == (0,)
    _, (slots, _) = tp.with_int8_records(lambda p, x: tp.conv2d(p, x))(
        tp.quantize_conv_int8(p_fp), x)  # int8 but slot-less
    assert slots.shape == (0,)


def test_static_matches_dynamic_at_batch1():
    """Batch 1 and margin 1: the calibrated scale is the dynamic one."""
    p = tp.assign_calib_slots(tp.quantize_conv_int8(_conv_params(0)))
    x = _x(1, (1, 8, 8, 8))
    y_dyn = tp.conv2d(p, x)
    _, (slots, scales) = tp.with_int8_records(lambda: tp.conv2d(p, x))()
    p_cal = tp.apply_int8_calibration(p, slots, scales, margin=1.0)
    assert "a_scale" in p_cal and "calib_slot" not in p_cal
    assert p_cal["a_scale"].dtype == torch.float32 and p_cal["a_scale"].ndim == 0
    np.testing.assert_allclose(y_dyn.numpy(), tp.conv2d(p_cal, x).numpy(), rtol=1e-6)


def test_max_merge_and_margin():
    p = tp.assign_calib_slots(tp.quantize_conv_int8(_conv_params(0)))
    p_cal = tp.apply_int8_calibration(p, torch.tensor([0, 0], dtype=torch.int32),
                                      torch.tensor([0.5, 2.0]), margin=1.1)
    assert np.isclose(float(p_cal["a_scale"]), 2.0 * 1.1, rtol=1e-6)
    p_other = tp.apply_int8_calibration(p, torch.tensor([5], dtype=torch.int32),
                                        torch.tensor([1.0]))
    assert "a_scale" not in p_other and "calib_slot" in p_other


def test_out_of_range_activations_clip_finite():
    p = tp.assign_calib_slots(tp.quantize_conv_int8(_conv_params(0)))
    x_cal = _x(1, (1, 8, 8, 8))
    _, (slots, scales) = tp.with_int8_records(lambda: tp.conv2d(p, x_cal))()
    y = tp.conv2d(tp.apply_int8_calibration(p, slots, scales), x_cal * 100.0)
    assert torch.isfinite(y).all()


def test_nested_slots_unique():
    tree = {"a": tp.quantize_conv_int8(_conv_params(0)),
            "b": [{"conv": tp.quantize_conv_int8(_conv_params(1))}, _conv_params(2)]}
    tagged = tp.assign_calib_slots(tree)
    assert {int(tagged["a"]["calib_slot"]), int(tagged["b"][0]["conv"]["calib_slot"])} == {0, 1}
    assert "calib_slot" not in tagged["b"][1]
    assert "calib_slot" not in tree["a"]  # the given dicts are not mutated


def test_calibration_matches_jax():
    """Records, max-merge and the baked scales on the same observations as
    JAX's ``apply_int8_calibration`` (the engine's end to end is in
    ``tests/test_torch_int8_engine.py``)."""
    rng = np.random.default_rng(0)
    pa, pb = _jconv(rng, 8, 16, 3), _jconv(rng, 16, 16, 3)
    jq = jp.assign_calib_slots({k: jp.quantize_conv_int8(jax.tree_util.tree_map(jnp.asarray, p))
                                for k, p in (("a", pa), ("b", pb))})
    tq = tp.assign_calib_slots({k: tp.quantize_conv_int8(_tconv(p))
                                for k, p in (("a", pa), ("b", pb))})
    x1, x2 = _x(1, (2, 8, 8, 8)), _x(2, (3, 8, 8, 8)) * 3

    def fwd(conv, tree, x):
        return conv(tree["b"], conv(tree["a"], x))

    jrec = [jp.with_int8_records(fwd)(jp.conv2d, jq, jnp.asarray(x.numpy()))[1] for x in (x1, x2)]
    trec = [tp.with_int8_records(fwd)(tp.conv2d, tq, x)[1] for x in (x1, x2)]
    for (js, jv), (ts, tv) in zip(jrec, trec):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    jcal = jp.apply_int8_calibration(jq, np.concatenate([np.asarray(r[0]) for r in jrec]),
                                     np.concatenate([np.asarray(r[1]) for r in jrec]), margin=1.05)
    tcal = tp.apply_int8_calibration(tq, torch.cat([r[0] for r in trec]),
                                     torch.cat([r[1] for r in trec]), margin=1.05)
    for k in ("a", "b"):
        np.testing.assert_allclose(float(tcal[k]["a_scale"]), float(jcal[k]["a_scale"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# the converter and the engine's casts on int8 trees
# ---------------------------------------------------------------------------


def test_converter_round_trips_an_int8_tree():
    """JAX's quantized, slotted and calibrated trees -> the port -> back,
    bit for bit; and through the flat state dict."""
    unet, vae = _decoder_and_unet_trees()
    jtree = jp.assign_calib_slots({"unet": junet.quantize_unet_int8(unet),
                                   "vae": jvae.quantize_decoder_int8(vae)})
    slots = np.arange(10, dtype=np.int32)
    jtree = jp.apply_int8_calibration(jtree, slots, np.linspace(0.01, 0.1, 10, dtype=np.float32))
    jnp_tree = jax.tree_util.tree_map(np.asarray, jtree)
    ttree = convert.from_jax_tree(jnp_tree)
    assert ttree["vae"]["decoder"]["up_blocks"][0]["upsamplers"][0]["conv"]["weight_int8"].ndim == 5
    back = convert.to_jax_tree(ttree)
    flat_j, tdef_j = jax.tree_util.tree_flatten_with_path(jnp_tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten_with_path(back)
    assert tdef_j == tdef_b
    for (path, a), (_, b) in zip(flat_j, flat_b):
        a = np.asarray(a)
        if a.dtype in (np.int8, np.int32):
            assert b.dtype == a.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    sd = convert.state_dict(ttree)
    assert any(k.endswith(".weight_int8") for k in sd) and any(k.endswith(".a_scale") for k in sd)
    again = convert.tree_from_state_dict(sd)
    for k, v in convert.state_dict(again).items():
        assert torch.equal(v, sd[k]), k
    assert sorted(convert.state_dict(again)) == sorted(sd)


def test_bf16_cast_keeps_int8_leaves_and_fp32_scales():
    """The engine's cast (``tree_to``) and a worker's copy (``own_copy``)
    keep int8 weights int8 in their layout and the scales fp32, as JAX
    keeps them; the other leaves take the compute dtype."""
    q = tp.assign_calib_slots({"conv": tp.quantize_conv_int8(_conv_params(0), fold_upsample=True),
                               "sc": tp.quantize_conv_int8(_conv_params(1))})
    q = tp.apply_int8_calibration(q, torch.tensor([1], dtype=torch.int32), torch.tensor([0.3]))
    for tree in (convert.tree_to(q, "cpu", torch.bfloat16),
                 tworkers.own_copy(convert.tree_to(q, "cpu", torch.bfloat16), torch.device("cpu"))):
        for name in ("conv", "sc"):
            p = tree[name]
            assert p["weight_int8"].dtype == torch.int8 and p["weight_int8"].is_contiguous()
            assert torch.equal(p["weight_int8"], q[name]["weight_int8"])
            assert p["kernel_scale"].dtype == torch.float32
            assert torch.equal(p["kernel_scale"], q[name]["kernel_scale"])
            assert p["bias"].dtype == torch.bfloat16
        assert tree["sc"]["a_scale"].dtype == torch.float32
        assert float(tree["sc"]["a_scale"]) == pytest.approx(0.3)
        assert tree["conv"]["calib_slot"].dtype == torch.int32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_engine_calibration_end_to_end(dtype):
    """``tests/test_int8_calibration.py``'s engine case on the port alone,
    in fp32 and in a bf16 engine: ``calibrate_int8`` refuses to run before
    ``onboard``, gives every int8 conv a static fp32 scale, and the
    calibrated images stay near the dynamic ones (median 0.15, as JAX's
    test); the bf16 engine keeps its int8 weights int8 and every scale
    fp32."""
    from instantrestore_tpu_torch.inference.serving import ServingEngine
    from instantrestore_tpu_torch.models import restorer as trest

    statics = trest.RestorerStatics(
        unet_cfg=tunet.UNetConfig(sample_size=16, block_out_channels=(32, 64, 64, 64),
                                  attention_heads=(1, 2, 2, 2), cross_attention_dim=16,
                                  norm_num_groups=8),
        vae_cfg=tvae.VAEConfig(block_out_channels=(8, 16, 16, 16), norm_num_groups=4),
        use_adain=True, train_input=False, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = trest.init_restorer_params(gen, statics, lora_rank_unet=2, lora_rank_vae=2)
    with pytest.raises(RuntimeError, match="onboard"):
        ServingEngine(params, statics, device="cpu", int8_unet=True).calibrate_int8([])
    eng = ServingEngine(params, statics, device="cpu", int8_decoder=True, int8_unet=True)
    convs = _int8_convs(eng.params)
    assert len(convs) == 95 and all("calib_slot" in p for p in convs)
    assert all(p["weight_int8"].dtype == torch.int8 and p["kernel_scale"].dtype == torch.float32
               and p["bias"].dtype == dtype for p in convs)
    assert _int8_convs(eng.params["original_unet"]) == _int8_convs(eng.params["original_vae"]) == []
    refs = torch.randint(0, 256, (2, 4, 128, 128, 3), dtype=torch.uint8, generator=gen)
    imgs = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8, generator=gen)
    ids = torch.tensor([0, 1])
    eng.onboard(refs, generator=torch.Generator().manual_seed(1))
    before = eng.restore(imgs, ids, generator=torch.Generator().manual_seed(3))
    assert eng.calibrate_int8([(imgs, ids, torch.Generator().manual_seed(3))]) == 95
    convs = _int8_convs(eng.params)
    assert all("a_scale" in p and "calib_slot" not in p and p["a_scale"].dtype == torch.float32
               for p in convs)
    after = eng.restore(imgs, ids, generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(after).all() and after.dtype == dtype
    assert float((after.float() - before.float()).abs().median()) < 0.15


def _int8_convs(tree):
    convs = []
    tp._map_int8_convs(tree, lambda p: convs.append(p) or p)
    return convs
