"""The generator training step's paths in the port alone, at tiny widths in
fp32 on the CPU: the kernels it runs where a gradient is wanted, the
streamed segment sums, the timestep draw, the refusals and the statics from
a model config. The inputs are those of ``tests/test_torch_train_step.py``
(the same JAX-initialised tree, batch and JAX draws, JAX's timestep drawn
from its key as its restorer draws it), without JAX's step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import unet as junet
from instantrestore_tpu.training import train_step as jstep
from instantrestore_tpu.training.losses import lpips as jlpips
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.training import optim as toptim
from instantrestore_tpu_torch.training import train_step as tstep
from instantrestore_tpu_torch.training.losses import composite as tcomp

from test_torch_attention_kernels import record_calls
from test_torch_cold import B, J_STATICS, N, RES, T_STATICS, jax_draws
from test_torch_serving import random_tree
from test_torch_train_step import (  # noqa: F401
    OPT_KW,
    _mask,
    _np_tree,
    _port_run,
    no_kernel_build,
    one_thread,
)


def jax_timestep(key) -> int:
    """The timestep JAX's ``restore_forward(timestep=None)`` draws from ``key``."""
    r_t = jrest._split_rng(key, 4)[3]
    idx = jax.random.randint(r_t, (), 0, len(jrest.NOISE_TIMESTEPS))
    return int(jnp.asarray(jrest.NOISE_TIMESTEPS)[idx])


@pytest.fixture(scope="module")
def setup():
    """The JAX tree, batch and first step's draws of
    ``tests/test_torch_train_step.py``."""
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    batch = {"image": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "gt": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "conditioning_images": rng.uniform(-1, 1, (B, N, RES, RES, 3)).astype(np.float32),
             "valid_indices": np.array([N, 1], np.int32)}
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0)
    lpips = random_tree(jlpips.init_lpips_params, jax.random.PRNGKey(1), seed=5)
    lpips["lins"] = [{"kernel": jnp.abs(l["kernel"]) * 0.05} for l in lpips["lins"]]
    return dict(params=_np_tree(params), lpips=_np_tree(lpips), batch=batch,
                steps=[dict(noise=jax_draws(key, B, N), timestep=jax_timestep(key))])


def test_step_runs_the_differentiable_kernels_where_a_gradient_is_wanted(setup, monkeypatch):
    """The frozen capture pass takes the inference kernels and no backward;
    the restoration nets take the LSE forward and both backward kernels, once
    per attention (tiny UNet: 9 shared + 7 self, VAE: 2; the capture: 16 + 1)."""
    from instantrestore_tpu_torch.ops import shared_attention as tsa

    calls = record_calls(monkeypatch, tfv, ["flash_fwd_lse_plain", "flash_bwd_dq_plain",
                                            "flash_bwd_dkv_plain"])
    serving = record_calls(monkeypatch, tsa, ["flash_attention_plain", "shared_flash_bound_plain"])
    _port_run(setup, steps=1)
    assert {n: calls.count(n) for n in set(calls)} == {
        "flash_fwd_lse_plain": 18, "flash_bwd_dq_plain": 18, "flash_bwd_dkv_plain": 18}
    assert serving == ["flash_attention_plain"] * 17
    del calls[:], serving[:]
    _port_run(setup, steps=1, remat=True)  # the stages' forward runs a second time
    assert calls.count("flash_fwd_lse_plain") == 36 and calls.count("flash_bwd_dq_plain") == 18
    assert serving == ["flash_attention_plain"] * 17


def test_segment_sums_step(setup):
    """save_seg_sums through the step: 9 streamed [B, h, Sq, N] tensors reach
    the loss and the attention regularisers get a gradient path."""
    params = convert.from_jax_tree(setup["params"])
    mask = _mask(tlora, params)
    ocfg = tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.CONSTANT, lambda_attn_reg=0.01,
                            lambda_pos_reg=0.1, lambda_neg_reg=0.1, **OPT_KW)
    seen = {}

    def loss_fn(out, b, cfg):
        seen["sums"] = out["attn_seg_sums"]
        return tcomp.compute_generator_loss(out, b, cfg, train_input=False, layer_idx=8)

    step = tstep.make_train_step(T_STATICS, ocfg, toptim.make_optimizer(ocfg, 100, mask), mask,
                                 loss_fn, use_fused_attention=True, remat=True,
                                 save_seg_sums=True, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    batch.update(pos_reg_idx=torch.tensor([0, 1]), neg_reg_idx=torch.tensor([1, -1]))
    s = setup["steps"][0]
    metrics, out = step(params, batch, noise=s["noise"], timestep=s["timestep"])
    assert len(seen["sums"]) == 9 and all(x.shape[0] == B and x.shape[-1] == N for x in seen["sums"])
    assert {"loss_attn_reg", "loss_attn_pos_reg", "loss_attn_neg_reg"} <= set(metrics)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    # the regularisers reach the shared layers' query projections
    to_q = params["unet"]["up_blocks"][3]["attentions"][2]["transformer_blocks"][0]["attn1"]["to_q"]
    assert to_q["lora_A"].grad.abs().max() > 0


def test_timestep_is_drawn_from_the_generator(setup):
    params = convert.from_jax_tree(setup["params"])
    img = torch.from_numpy(setup["batch"]["image"])
    refs = torch.from_numpy(setup["batch"]["conditioning_images"])
    drawn = set()
    with torch.no_grad():
        for seed in range(6):
            out = trest.restore_forward(params, img, refs, statics=T_STATICS, timestep=None,
                                        generator=torch.Generator().manual_seed(seed))
            again = trest.restore_forward(params, img, refs, statics=T_STATICS, timestep=None,
                                          generator=torch.Generator().manual_seed(seed))
            # the drawn timestep stays on the device (a 0-d tensor)
            assert out["timestep"].ndim == 0 and out["timestep"] == again["timestep"]
            assert torch.equal(out["output_image"], again["output_image"])
            assert out["latent_pred"].shape == (B, RES // 8, RES // 8, 4)
            drawn.add(int(out["timestep"]))
        with pytest.raises(ValueError, match="torch.Generator"):
            trest.restore_forward(params, img, refs, statics=T_STATICS, timestep=None,
                                  noise=setup["steps"][0]["noise"])
    assert drawn <= set(trest.NOISE_TIMESTEPS) and len(drawn) > 1


def test_entry_point_refuses_the_cpu_unasked_and_shared_leaves(setup):
    params = convert.from_jax_tree(setup["params"])
    mask = _mask(tlora, params)
    ocfg = tcfg.OptimConfig(**OPT_KW)
    opt = toptim.make_optimizer(ocfg, 100, mask)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tstep.make_train_step(T_STATICS, ocfg, opt, mask)
    step = tstep.make_train_step(T_STATICS, ocfg, opt, mask, device="cpu")
    params["unet_orig_conv_in"] = dict(params["unet"]["conv_in"])  # the frozen view aliases a trainable
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    with pytest.raises(ValueError, match="own copy"):
        step(params, batch, noise=setup["steps"][0]["noise"], timestep=249)
    # init_restorer_params gives the frozen view its own copy
    p = trest.init_restorer_params(torch.Generator().manual_seed(0), T_STATICS, lora_rank_unet=2,
                                   lora_rank_vae=2)
    assert p["unet_orig_conv_in"]["weight"] is not p["unet"]["conv_in"]["weight"]
    assert torch.equal(p["unet_orig_conv_in"]["weight"], p["unet"]["conv_in"]["weight"])


def test_default_loss_fn_and_statics_from_model_config(rng):
    pred = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32))
    for kw in (dict(lambda_l2=2.0), dict(lambda_l2=0.0, lambda_l1=3.0), dict(lambda_l2=1.0, lambda_l1=1.0)):
        jt, jl = jstep.default_loss_fn({"output_image": jnp.asarray(pred.numpy())},
                                       {"gt": jnp.asarray(gt.numpy())}, jcfg.OptimConfig(**kw))
        tt, tl = tstep.default_loss_fn({"output_image": pred}, {"gt": gt}, tcfg.OptimConfig(**kw))
        assert set(jl) == set(tl)
        np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    mj, mt = jcfg.ModelConfig(lora_rank_unet=8, use_adain=True, train_input=False), tcfg.ModelConfig(
        lora_rank_unet=8, use_adain=True, train_input=False)
    js, ts = jrest.RestorerStatics.from_model_config(mj), trest.RestorerStatics.from_model_config(mt)
    for f in dataclasses.fields(ts):
        if f.name == "freeu":  # the JAX package's FreeU is its module constant
            assert dataclasses.asdict(ts.freeu) == dataclasses.asdict(junet.DEFAULT_FREEU)
        elif f.name not in ("unet_cfg", "vae_cfg", "compute_dtype"):
            assert getattr(ts, f.name) == getattr(js, f.name), f.name
    for kw in (dict(train_reference_networks=True), dict(use_shortcuts=True),
               dict(condition_on_face_embeds=True)):
        js = jrest.RestorerStatics.from_model_config(jcfg.ModelConfig(**kw))
        ts = trest.RestorerStatics.from_model_config(tcfg.ModelConfig(**kw))
        for f in dataclasses.fields(ts):
            if f.name == "freeu":
                assert dataclasses.asdict(ts.freeu) == dataclasses.asdict(junet.DEFAULT_FREEU)
            elif f.name not in ("unet_cfg", "vae_cfg", "compute_dtype"):
                assert getattr(ts, f.name) == getattr(js, f.name), (kw, f.name)
