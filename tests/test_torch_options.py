"""The VAE's skip convs (``use_shortcuts``) and LoRA on the capture networks
(``train_reference_networks``): the port vs the JAX package at tiny widths,
fp32, on the CPU; and the converter both ways for every leaf these options
and FaceID conditioning add.

JAX's init fixes the skip convs' widths at SD's (512 and 256), which a tiny
decoder cannot run, so both packages are given skip convs of the tiny
decoder's widths (as ``tests/test_vae.py::test_decode_with_skips_runs``
does), with LoRA on them as ``VAE_SHORTCUT_TARGETS`` asks; the init's own
shapes are held to JAX's separately. JAX's noise is redrawn with its own
helpers (``jax_draws``) and injected.

Tolerances: 1e-3 max-abs on output images (as ``tests/test_torch_cold.py``);
the train step's loss 1e-5 relative and every trainable leaf's gradient
1e-3 of its largest entry plus 1e-7 (as ``tests/test_torch_train_step.py``),
JAX's gradient by ``jax.value_and_grad`` of its forward and L2 in plain XLA
against the port's step through its kernels' plain versions (fp32 sums in
another order); converted trees bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.utils.torch_convert import tree_to_torch_state_dict
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.ops import shared_attention as tsa
from instantrestore_tpu_torch.training import coach as tcoach_mod
from instantrestore_tpu_torch.training import optim as toptim
from instantrestore_tpu_torch.training import train_step as tstep

from test_torch_attention_kernels import record_calls
from test_torch_coach_port import small_cfg, small_roots  # noqa: F401
from test_torch_cold import B, N, RES, jax_draws, statics_pair
from test_torch_serving import random_tree

# (in, out) of skip_conv_1..4 for the tiny VAE (8, 16, 16, 16): the reversed
# encoder activations' widths into the decoder's widths before each up block
TINY_SKIPS = [(16, 16), (16, 16), (8, 16), (8, 16)]
OPTS = dict(use_shortcuts=True, train_reference_networks=True)
# the cold tests' tiny widths with one layer a block (six shared layers), to
# keep JAX's compile of its gradient short
J_STATICS, T_STATICS = (
    dataclasses.replace(s, unet_cfg=dataclasses.replace(s.unet_cfg, layers_per_block=1),
                        vae_cfg=dataclasses.replace(s.vae_cfg, layers_per_block=1))
    for s in statics_pair(use_adain=True, train_input=False))
J_OPTS = dataclasses.replace(J_STATICS, **OPTS)
T_OPTS = dataclasses.replace(T_STATICS, **OPTS)
TIMESTEP = 499


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _with_tiny_skips(vae, key, rank):
    """A JAX VAE tree with skip convs of the tiny widths and LoRA on them."""
    dec = dict(vae["decoder"])
    for i, (cin, cout) in enumerate(TINY_SKIPS, start=1):
        dec[f"skip_conv_{i}"] = {"kernel": jnp.zeros((1, 1, cin, cout), jnp.float32)}
    return jlora.attach_lora(dict(vae, decoder=dec), key, rank, jlora.VAE_SHORTCUT_TARGETS)


def jax_options_init(key):
    """JAX's init with both options, the skip convs at the tiny widths."""
    p = jrest.init_restorer_params(key, dataclasses.replace(J_OPTS, use_shortcuts=False),
                                   lora_rank_unet=4, lora_rank_vae=4)
    p["vae"] = _with_tiny_skips(p["vae"], key, 4)
    p["original_vae"] = _with_tiny_skips(p["original_vae"], key, 16)
    return p


@pytest.fixture(scope="module")
def models():
    params = random_tree(jax_options_init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    batch = {"image": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "gt": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "conditioning_images": rng.uniform(-1, 1, (B, N, RES, RES, 3)).astype(np.float32),
             "valid_indices": np.array([N, 1], np.int32)}
    return dict(jax=params, np=jax.tree_util.tree_map(np.asarray, params), batch=batch)


def _torch(models):
    return convert.from_jax_tree(models["np"])


def test_cold_forward_with_skip_convs_and_capture_lora_matches_jax(models):
    """The serving bundle (LoRA merged into the restoration nets, the skip
    convs' too; the capture nets' LoRA applied at 0.5) restores as JAX's;
    without the skip convs the output moves."""
    key = jax.random.PRNGKey(4)
    b = models["batch"]
    fwd = jax.jit(lambda p, x, c, v, r: jrest.restore_forward(
        p, x, c, v, rng=r, statics=J_OPTS, timestep=249)["output_image"])
    ref = np.asarray(fwd(jrest.serving_bundle(models["jax"], J_OPTS), b["image"],
                         b["conditioning_images"], b["valid_indices"], key))
    bundle = trest.serving_bundle(_torch(models), T_OPTS)
    assert "skip_conv_1" in bundle["vae"]["decoder"]
    assert "lora_A" in bundle["original_vae"]["decoder"]["skip_conv_1"]
    args = [torch.from_numpy(b[k]) for k in ("image", "conditioning_images", "valid_indices")]
    noise = jax_draws(key, B, N)
    with torch.no_grad():
        out = trest.restore_forward(bundle, *args, statics=T_OPTS, noise=noise)["output_image"]
        plain = trest.restore_forward(bundle, *args, noise=noise, statics=dataclasses.replace(
            T_OPTS, use_shortcuts=False))["output_image"]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)
    assert float((plain - out).abs().max()) > 1e-2


def coach_mask(params):
    """The Coach's generator mask with both options (``g_mask``, as JAX's
    Coach builds it, ``instantrestore_tpu/training/coach.py:236-254``)."""
    skips = ("skip_conv_1", "skip_conv_2", "skip_conv_3", "skip_conv_4")
    return {"unet": tlora.trainable_mask(params["unet"], extra_trainable=("conv_in",)),
            "unet_orig_conv_in": tlora.trainable_mask(params["unet_orig_conv_in"]),
            "vae": tlora.trainable_mask(params["vae"], extra_trainable=skips),
            "caption_enc": False,
            "original_unet": tlora.trainable_mask(params["original_unet"],
                                                  extra_trainable=("conv_in",)),
            "original_vae": tlora.trainable_mask(params["original_vae"])}


def jax_coach_mask(jp):
    """JAX's Coach's generator mask with both options
    (``instantrestore_tpu/training/coach.py:236-254``)."""
    skips = ("skip_conv_1", "skip_conv_2", "skip_conv_3", "skip_conv_4")
    mask = {"unet": jlora.trainable_mask(jp["unet"], extra_trainable=("conv_in",)),
            "unet_orig_conv_in": jlora.trainable_mask(jp["unet_orig_conv_in"]),
            "vae": jlora.trainable_mask(jp["vae"], extra_trainable=skips),
            "original_unet": jlora.trainable_mask(jp["original_unet"],
                                                  extra_trainable=("conv_in",)),
            "original_vae": jlora.trainable_mask(jp["original_vae"])}
    mask["caption_enc"] = False
    return mask


@pytest.fixture(scope="module")
def jax_grads(models):
    """JAX's L2 loss of one training forward and its gradient w.r.t. every
    leaf of the bundle the Coach trains (the others under stop_gradient, as
    in JAX's train step)."""
    b = {k: jnp.asarray(v) for k, v in models["batch"].items()}
    key = jax.random.PRNGKey(7)
    mask = jax_coach_mask(models["jax"])

    def loss(p):
        p = jax.tree_util.tree_map(lambda x, m: x if m else jax.lax.stop_gradient(x), p, mask)
        out = jrest.restore_forward(p, b["image"], b["conditioning_images"], b["valid_indices"],
                                    rng=key, statics=J_OPTS, timestep=TIMESTEP)
        return jnp.mean(jnp.square(out["output_image"] - b["gt"]))

    value, grads = jax.jit(jax.value_and_grad(loss))(models["jax"])
    return float(value), jax.tree_util.tree_map(np.asarray, grads), jax_draws(key, B, N)


def _group(path) -> str:
    keys = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
    kind = ("lora" if keys[-1] in ("lora_A", "lora_B") else "skip_conv"
            if any(k.startswith("skip_conv_") for k in keys) else keys[1] if len(keys) > 2
            else keys[-1])
    return f"{keys[0]}.{kind}"


def test_train_step_loss_and_capture_gradients_match_jax(models, jax_grads, monkeypatch):
    """One step of the port's ``make_train_step`` (the kernels' plain
    versions under autograd) with the Coach's mask: the loss and the
    gradient of every trainable leaf, the capture nets' LoRA and conv_in
    and the skip convs among them, as JAX's; the capture pass now runs the
    differentiable attention (11 more forwards with their LSE: the tiny
    UNet's 10 self-attentions and the VAE's; 10 more backwards, as the last
    one's output reaches no captured K/V) and no inference kernel; the
    shared layers' reference K/V get their gradient."""
    ref_loss, ref_grads, noise = jax_grads
    params = _torch(models)
    mask = coach_mask(params)
    ocfg = tcfg.OptimConfig(lambda_l2=1.0, lambda_lpips=0.0, learning_rate=1e-3,
                            lr_warmup_steps=0)
    step = tstep.make_train_step(T_OPTS, ocfg, toptim.make_optimizer(ocfg, 100, mask), mask,
                                 use_fused_attention=True, device="cpu")
    calls = record_calls(monkeypatch, tfv, ["flash_fwd_lse_plain", "flash_bwd_dq_plain",
                                            "flash_bwd_dkv_plain"])
    serving = record_calls(monkeypatch, tsa, ["flash_attention_plain"])
    batch = {k: torch.from_numpy(v) for k, v in models["batch"].items()}
    metrics, _ = step(params, batch, noise=noise, timestep=TIMESTEP)
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    assert {n: calls.count(n) for n in set(calls)} == {
        "flash_fwd_lse_plain": 23, "flash_bwd_dq_plain": 22, "flash_bwd_dkv_plain": 22}
    assert serving == []
    grads = jax.tree_util.tree_map(lambda t, m: t.grad if m else torch.zeros_like(t),
                                   params, mask)
    got = jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(grads))
    ref = dict(jax.tree_util.tree_leaves_with_path(ref_grads))
    groups = {}
    for path, g in got:
        r = ref[path]
        if not g.any():  # frozen here, or a leaf no loss reaches
            continue
        np.testing.assert_allclose(g, r, atol=1e-3 * np.abs(r).max() + 1e-7, err_msg=str(path))
        groups[_group(path)] = groups.get(_group(path), 0) + 1
    for want in ("original_unet.lora", "original_unet.conv_in", "original_vae.lora",
                 "vae.skip_conv", "vae.lora", "unet.lora", "unet.conv_in"):
        assert groups.get(want, 0) > 0, (want, groups)


def test_init_shapes_and_converter_both_ways_for_the_new_leaves():
    """The port's init with every option gives JAX's tree: the same names
    and shapes under ``to_jax_tree`` (skip convs of SD's widths, rank-16
    capture LoRA, the FaceID projections); a JAX tree of them converts to
    the diffusers/peft names JAX's exporter writes and back, bit for bit."""
    kw = dict(use_shortcuts=True, train_reference_networks=True, condition_on_face_embeds=True)
    jstatics = dataclasses.replace(J_STATICS, **kw)
    shapes = jax.eval_shape(lambda k: jrest.init_restorer_params(k, jstatics, lora_rank_unet=4,
                                                                 lora_rank_vae=4),
                            jax.random.PRNGKey(0))
    port = trest.init_restorer_params(torch.Generator().manual_seed(0),
                                      dataclasses.replace(T_STATICS, **kw), lora_rank_unet=4,
                                      lora_rank_vae=4)
    got = jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(port))
    want = jax.tree_util.tree_leaves_with_path(shapes)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(g.shape == w.shape for (_, g), (_, w) in zip(got, want))
    dec = port["vae"]["decoder"]
    assert dec["skip_conv_4"]["weight"].shape == (256, 8, 1, 1)
    assert torch.all(dec["skip_conv_1"]["weight"] == 1e-5) and "lora_A" in dec["skip_conv_1"]
    attn2 = port["unet"]["up_blocks"][1]["attentions"][0]["transformer_blocks"][0]["attn2"]
    assert attn2["face_projection"]["weight"].shape == (16, 512)
    assert set(attn2["to_k_face_embed"]) == {"weight"}
    assert port["original_unet"]["conv_out"]["lora_A"].shape[0] == 16
    jtree = random_tree(lambda k: jrest.init_restorer_params(k, jstatics, lora_rank_unet=4,
                                                             lora_rank_vae=4),
                        jax.random.PRNGKey(1))
    for net in ("unet", "vae", "original_unet", "original_vae"):
        tree = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, jtree[net]))
        sd = convert.state_dict(tree)
        ref = tree_to_torch_state_dict(jtree[net])
        assert set(sd) == set(ref), net
        for name, value in ref.items():
            np.testing.assert_array_equal(sd[name].numpy(), np.asarray(value), err_msg=name)
        back = convert.to_jax_tree(convert.tree_from_state_dict(sd))
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                  jax.tree_util.tree_leaves_with_path(jtree[net]), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))
    names = set(convert.state_dict(port["unet"]))
    assert "up_blocks.1.attentions.0.transformer_blocks.0.attn2.face_projection.bias" in names
    assert "decoder.skip_conv_2.lora_B.default.weight" in set(convert.state_dict(port["vae"]))


def test_trainable_leaves_have_their_own_tensors():
    """The step updates in place: the port's init gives the capture nets'
    conv_in and skip convs their own tensors (frozen base weights stay
    shared), and the step refuses a bundle whose trainable tensor stands
    twice."""
    port = trest.init_restorer_params(torch.Generator().manual_seed(0), T_OPTS,
                                      lora_rank_unet=2, lora_rank_vae=2)
    mask = coach_mask(port)
    assert not tstep._aliased(port, {id(t) for t in toptim.trainable_leaves(port, mask)})
    ou, u = port["original_unet"], port["unet"]
    assert ou["conv_in"]["weight"] is not u["conv_in"]["weight"]
    assert ou["conv_in"]["weight"] is not port["unet_orig_conv_in"]["weight"]
    assert torch.equal(ou["conv_in"]["weight"], u["conv_in"]["weight"])
    assert ou["conv_out"]["weight"] is u["conv_out"]["weight"]  # frozen: shared
    ov, v = port["original_vae"]["decoder"], port["vae"]["decoder"]
    assert ov["skip_conv_1"]["weight"] is not v["skip_conv_1"]["weight"]
    port["original_unet"]["conv_in"] = port["unet"]["conv_in"]
    ocfg = tcfg.OptimConfig(lambda_l2=1.0, lambda_lpips=0.0)
    step = tstep.make_train_step(T_OPTS, ocfg, toptim.make_optimizer(ocfg, 10, mask), mask,
                                 device="cpu")
    with pytest.raises(ValueError, match="own copy") as info:
        step(port, {})
    assert "original_unet.conv_in.weight" in str(info.value)


def test_coach_mask_and_full_resume_carry_the_capture_trees(models, small_roots, tmp_path):
    """The Coach with both options trains what JAX's Coach trains, leaf by
    leaf (the capture nets' LoRA and conv_in, the skip convs); a full save
    after a step resumes into a Coach of other weights bit for bit, the new
    trees and their AdamW moments included."""
    over = dict(steps__max_steps=1, steps__save_interval=1, optim__lambda_gan=0.0,
                optim__lambda_lpips=0.0, optim__lr_warmup_steps=0, model__use_shortcuts=True,
                model__train_reference_networks=True)
    cfg = small_cfg(small_roots, tmp_path, "capture_a", **over)
    a = tcoach_mod.Coach(cfg, statics=T_OPTS, params=_torch(models), device="cpu")
    assert set(a.g_mask) >= {"original_unet", "original_vae"}
    ones = jax.tree_util.tree_map(lambda t, m: torch.full_like(t, float(m)), a.params, a.g_mask)
    jmask = jax_coach_mask(models["jax"])
    for net in ("unet", "vae", "original_unet", "original_vae"):
        want = jmask[net]
        got = jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(ones[net]))
        want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got] == [p for p, _ in want], net
        assert all(bool(g.all()) == w and bool(g.any()) == w for (_, g), (_, w) in
                   zip(got, want)), net
    start = {n: t.clone() for n, t in tcoach_mod._named_leaves(a.params)}
    a.train()
    moved = {n for n, t in tcoach_mod._named_leaves(a.params) if not torch.equal(t, start[n])}
    assert any(n.startswith("original_unet.") and "lora" in n for n in moved)
    assert "original_unet.conv_in.weight" in moved and "vae.decoder.skip_conv_1.weight" in moved
    assert not any(n.startswith("unet_orig_conv_in") for n in moved)

    cfg2 = small_cfg(small_roots, tmp_path, "capture_b", **over)
    cfg2.log.resume_from = str(cfg.log.exp_dir / "checkpoints" / "step_1")
    other = random_tree(jax_options_init, jax.random.PRNGKey(0), seed=1)
    b = tcoach_mod.Coach(cfg2, statics=T_OPTS, params=convert.from_jax_tree(
        jax.tree_util.tree_map(np.asarray, other)), device="cpu")
    assert b.train_step_num == 1 and b.g_opt.count == 1
    for (name, got), (_, want) in zip(tcoach_mod._named_leaves(b.params),
                                      tcoach_mod._named_leaves(a.params), strict=True):
        assert torch.equal(got, want), name
    assert len(b.g_opt.exp_avg) == len(toptim.trainable_leaves(b.params, b.g_mask))
    for got, want in zip(b.g_opt.exp_avg + b.g_opt.exp_avg_sq,
                         a.g_opt.exp_avg + a.g_opt.exp_avg_sq, strict=True):
        assert torch.equal(got, want)


def test_statics_carry_the_capture_lora_options():
    for kw in (dict(train_reference_networks=True), dict()):
        mj, mt = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
        js, ts = jrest.RestorerStatics.from_model_config(mj), trest.RestorerStatics.from_model_config(mt)
        assert ts.train_reference_networks == js.train_reference_networks
        assert ts.reference_lora_scaling == js.reference_lora_scaling == 0.5
