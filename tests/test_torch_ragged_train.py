"""One generator training step at sample_size 24 (192 px), whose attention
shapes are off the CUDA tiles' 64 rows: the port's ``make_train_step`` (on
the CPU, the kernels' plain versions under ``torch.autograd.Function``)
against the JAX package's (Pallas forward and backward in interpret mode),
tiny widths at head dim 64, one layer a block, fp32. The algorithm switches
choose only the frozen capture's kernels, whose shapes
``tests/test_torch_ragged_models.py`` holds under both; the step runs under
the default ones.

The restoration UNet's attention runs at 576, 144, 36 and 9 tokens, its
shared layers over segments of 576, 144 and 36 keys. JAX's differentiable
shared attention blocks a segment at 512 keys by default, which 576 is no
multiple of: the test hands it blocks of 1024 (one block of each segment),
as a caller of the JAX package may; the port takes no block. Noise and
timestep as
``tests/test_torch_train_step.py``; tolerances as there: 1e-4 on the loss,
gradients 1e-3 of each leaf's largest entry plus 1e-7.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.ops import flash_vjp as jfv
from instantrestore_tpu.training import optim as joptim
from instantrestore_tpu.training import train_step as jstep
from instantrestore_tpu.training.losses import composite as jcomp
from instantrestore_tpu.training.losses import lpips as jlpips
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.configs import config as tcfg
from instantrestore_tpu_torch.models import lora as tlora
from instantrestore_tpu_torch.ops import _build
from instantrestore_tpu_torch.ops import flash_vjp as tfv
from instantrestore_tpu_torch.training import optim as toptim
from instantrestore_tpu_torch.training import train_step as tstep
from instantrestore_tpu_torch.training.losses import composite as tcomp

from test_torch_attention_kernels import record_calls
from test_torch_ragged_models import J_STATICS, RES, T_STATICS, jax_draws
from test_torch_serving import random_tree

B, N = 2, 2
OPT_KW = dict(lambda_l2=1.0, lambda_lpips=1.0, learning_rate=1e-3, lr_warmup_steps=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_kernel_build(monkeypatch):
    """CPU tensors must never reach the CUDA build."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name}")
    monkeypatch.setattr(_build, "load", refuse)
    tfv.reset_launch_counts()
    yield
    assert not any(fn.launches for fn in tfv.KERNEL_WRAPPERS)


def _mask(lora_mod, params):
    false = jax.tree_util.tree_map(lambda _: False, params["caption_enc"])
    return {"unet": lora_mod.trainable_mask(params["unet"], extra_trainable=("conv_in",)),
            "unet_orig_conv_in": lora_mod.trainable_mask(params["unet_orig_conv_in"]),
            "vae": lora_mod.trainable_mask(params["vae"]),
            "caption_enc": false}


def test_train_step_at_sample_size_24_matches_jax(monkeypatch):
    """The loss and every trainable leaf's gradient of one step; the port
    ran the differentiable attention's plain versions once per attention of
    the restoration nets (6 shared, 4 self, 2 VAE)."""
    monkeypatch.setattr(jfv, "shared_flash_attention",
                        functools.partial(jfv.shared_flash_attention, block_k=1024))
    # the frozen capture's primal shared kernels read JAX's own tile knobs
    monkeypatch.setenv("INSTANTRESTORE_BLOCK_K", "1024")
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    lpips = random_tree(jlpips.init_lpips_params, jax.random.PRNGKey(1), seed=5)
    lpips["lins"] = [{"kernel": jnp.abs(l["kernel"]) * 0.05} for l in lpips["lins"]]
    rng = np.random.default_rng(23)
    batch = {"image": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "gt": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "conditioning_images": rng.uniform(-1, 1, (B, N, RES, RES, 3)).astype(np.float32),
             "valid_indices": np.array([N, 1], np.int32)}

    # JAX: one jitted step; a pass-through transform ahead of the optimizer keeps the gradients
    jmask = _mask(jlora, params)
    ocfg = jcfg.OptimConfig(scheduler_type=jcfg.SchedulerType.CONSTANT, **OPT_KW)
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, state, p=None: (g, g))
    opt = optax.chain(stash, joptim.make_optimizer(ocfg, 100, jmask))

    def loss_fn(out, b, cfg):
        return jcomp.compute_generator_loss(out, b, cfg, rng=jax.random.PRNGKey(0),
                                            lpips_params=lpips, train_input=False)

    step = jax.jit(jstep.make_train_step(J_STATICS, ocfg, opt, jmask, loss_fn,
                                         use_fused_attention=True))
    key = jax.random.PRNGKey(3)
    _, state, metrics, out = step(params, opt.init(params), {k: jnp.asarray(v) for k, v in
                                                             batch.items()}, key)
    jgrads = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, state[0]))

    # the port, from the converted tree, on JAX's noise and timestep
    tparams = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params))
    tlp = convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, lpips))
    tmask = _mask(tlora, tparams)
    tocfg = tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.CONSTANT, **OPT_KW)
    tstep_fn = tstep.make_train_step(
        T_STATICS, tocfg, toptim.make_optimizer(tocfg, 100, tmask), tmask,
        lambda o, b, cfg: tcomp.compute_generator_loss(o, b, cfg, lpips_params=tlp,
                                                       train_input=False),
        use_fused_attention=True, device="cpu")
    calls = record_calls(monkeypatch, tfv, ["flash_fwd_lse_plain", "flash_bwd_dq_plain",
                                            "flash_bwd_dkv_plain"])
    tmetrics, _ = tstep_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                           noise=jax_draws(key, B, N), timestep=int(out["timestep"]))
    assert {n: calls.count(n) for n in set(calls)} == {
        "flash_fwd_lse_plain": 12, "flash_bwd_dq_plain": 12, "flash_bwd_dkv_plain": 12}
    np.testing.assert_allclose(float(tmetrics["loss"]), float(metrics["loss"]), atol=1e-4)

    grads = iter(t.grad for t in toptim.trainable_leaves(tparams, tmask))
    gtree = jax.tree_util.tree_map(lambda t, m: next(grads) if m else torch.zeros_like(t),
                                   tparams, tmask)
    got = jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(gtree))
    flags = jax.tree_util.tree_leaves(jmask)
    assert len(got) == len(jgrads) == len(flags)
    checked = 0
    for (path, g), r, m in zip(got, jgrads, flags):
        if m:
            np.testing.assert_allclose(g, r, atol=1e-3 * np.abs(r).max() + 1e-7,
                                       err_msg=str(path))
            checked += bool(r.any())
    assert checked > 150
