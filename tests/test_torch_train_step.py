"""The generator training step as a whole: the port's ``make_train_step`` vs
the JAX package's, at tiny widths in fp32 on the CPU, fused attention on both
sides (JAX: the Pallas forward and backward kernels in interpret mode; the
port: their plain versions under ``torch.autograd.Function``).

One JAX param tree goes through ``convert.from_jax_tree``; the noise JAX drew
is redrawn with its own key-splitting helpers (``jax_draws``) and the timestep
it drew is read from ``out["timestep"]``; both are injected into the port.
JAX's gradients come out of its jitted step through a pass-through transform
chained before its optimizer.

The cases that need the port's step alone (the kernels it runs, the segment
sums, the timestep draw, the refusals) are in
``tests/test_torch_train_step_paths.py``, off this file's JAX compile.

Tolerances: 1e-4 on the loss; gradients 1e-3 of each leaf's largest entry
(plus 1e-7: two fp32 pipelines of ~100 layers that sum in different orders);
params after 3 AdamW steps 2e-2 of the distance a leaf travelled (Adam
divides a gradient by its running magnitude, so a step is as uncertain as its
gradient's relative error, and entries whose gradient is pure rounding noise
take a step of either sign: those are bounded by the step size instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instantrestore_tpu.configs import config as jcfg
from instantrestore_tpu.models import lora as jlora
from instantrestore_tpu.models import restorer as jrest
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

from test_torch_cold import B, J_STATICS, N, RES, T_STATICS, jax_draws
from test_torch_serving import random_tree

STEPS, LR = 3, 1e-3
OPT_KW = dict(lambda_l2=1.0, lambda_lpips=1.0, learning_rate=LR, lr_warmup_steps=0)


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """The JAX tree, LPIPS tree, batch, and three steps of JAX's train step
    with their gradients, noise and timesteps."""
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, J_STATICS, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    lpips = random_tree(jlpips.init_lpips_params, jax.random.PRNGKey(1), seed=5)
    lpips["lins"] = [{"kernel": jnp.abs(l["kernel"]) * 0.05} for l in lpips["lins"]]
    rng = np.random.default_rng(21)
    batch = {"image": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "gt": rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
             "conditioning_images": rng.uniform(-1, 1, (B, N, RES, RES, 3)).astype(np.float32),
             "valid_indices": np.array([N, 1], np.int32)}
    mask = _mask(jlora, params)
    ocfg = jcfg.OptimConfig(scheduler_type=jcfg.SchedulerType.CONSTANT, **OPT_KW)
    # a pass-through transform ahead of the optimizer keeps the raw gradients in its state
    stash = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, state, p=None: (g, g))
    opt = optax.chain(stash, joptim.make_optimizer(ocfg, 100, mask))

    def loss_fn(out, b, cfg):
        return jcomp.compute_generator_loss(out, b, cfg, rng=jax.random.PRNGKey(0),
                                            lpips_params=lpips, train_input=False)

    step = jax.jit(jstep.make_train_step(J_STATICS, ocfg, opt, mask, loss_fn,
                                         use_fused_attention=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state, p, steps = opt.init(params), params, []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        p, state, metrics, out = step(p, state, jb, key)
        steps.append(dict(loss=float(metrics["loss"]), terms={k: float(v) for k, v in metrics.items()},
                          timestep=int(out["timestep"]), noise=jax_draws(key, B, N),
                          grads=_np_tree(state[0]) if i == 0 else None))
    return dict(params=_np_tree(params), final=_np_tree(p), lpips=_np_tree(lpips), batch=batch,
                mask=mask, steps=steps)


def _port_run(setup, *, fused=True, remat=False, steps=STEPS, **kw):
    """The port's train step from the converted start; returns the params,
    the per-step metrics and the first step's gradients."""
    params = convert.from_jax_tree(setup["params"])
    lpips = convert.from_jax_tree(setup["lpips"])
    mask = _mask(tlora, params)
    ocfg = tcfg.OptimConfig(scheduler_type=tcfg.SchedulerType.CONSTANT, **OPT_KW)
    step = tstep.make_train_step(
        T_STATICS, ocfg, toptim.make_optimizer(ocfg, 100, mask), mask,
        lambda out, b, cfg: tcomp.compute_generator_loss(out, b, cfg, lpips_params=lpips,
                                                         train_input=False),
        use_fused_attention=fused, remat=remat, device="cpu", **kw)
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    metrics, grads = [], None
    for s in setup["steps"][:steps]:
        m, out = step(params, batch, noise=s["noise"], timestep=s["timestep"])
        assert out["timestep"] == s["timestep"]
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = [t.grad.clone() for t in toptim.trainable_leaves(params, mask)]
    return params, mask, metrics, grads


@pytest.fixture(scope="module")
def port_fused(setup):
    return _port_run(setup)


def test_loss_matches_jax(setup, port_fused):
    _, _, metrics, _ = port_fused
    assert all(s["timestep"] in jrest.NOISE_TIMESTEPS for s in setup["steps"])
    for s, m in zip(setup["steps"], metrics):
        np.testing.assert_allclose(m["loss"], s["loss"], atol=1e-4)
        for k in ("loss_l2", "loss_lpips"):
            np.testing.assert_allclose(m[k], s["terms"][k], atol=1e-4, err_msg=k)
        assert m["grad_norm"] > 0


def test_gradients_match_jax(setup, port_fused):
    """Every trainable leaf's gradient of the first step, laid beside JAX's
    through ``to_jax_tree``."""
    params, mask, _, grads = port_fused
    it = iter(grads)
    gtree = jax.tree_util.tree_map(lambda t, m: next(it) if m else torch.zeros_like(t), params, mask)
    got = jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(gtree))
    ref = jax.tree_util.tree_leaves_with_path(setup["steps"][0]["grads"])
    jmask = jax.tree_util.tree_leaves(setup["mask"])
    assert [p for p, _ in got] == [p for p, _ in ref] and len(jmask) == len(ref)
    assert sum(jmask) == len(grads) > 600
    nonzero = 0
    for (path, g), (_, r), m in zip(got, ref, jmask):
        if not m:
            assert not r.any(), path  # JAX's stop_gradient on the frozen leaves
            continue
        np.testing.assert_allclose(g, r, atol=1e-3 * np.abs(r).max() + 1e-7, err_msg=str(path))
        nonzero += bool(r.any())
    assert nonzero > 600  # all but the refs-only shared layers' input-key factors


def test_params_after_three_steps_match_jax(setup, port_fused):
    params, mask, _, _ = port_fused
    got = jax.tree_util.tree_leaves_with_path(convert.to_jax_tree(params))
    ref = jax.tree_util.tree_leaves(setup["final"])
    start = jax.tree_util.tree_leaves(setup["params"])
    jmask = jax.tree_util.tree_leaves(setup["mask"])
    close = total = 0
    for (path, g), r, s, m in zip(got, ref, start, jmask):
        if not m:
            # frozen: bit-identical to the start, in the port and in JAX
            np.testing.assert_array_equal(g, s, err_msg=str(path))
            np.testing.assert_array_equal(r, s, err_msg=str(path))
            continue
        assert not np.array_equal(g, s), path
        # no entry is farther off than the steps it took
        np.testing.assert_allclose(g, r, atol=2 * STEPS * LR, err_msg=str(path))
        moved = np.abs(r - s)
        ok = np.abs(g - r) <= 2e-2 * moved + 1e-7
        close += ok.sum()
        total += ok.size
    assert close / total > 0.999, close / total


def test_remat_is_bit_identical(setup, port_fused):
    """Checkpointed stages rebuild exactly the first forward: same loss,
    gradients and params (use_reentrant=False keeps gradient mode on, so the
    rebuilt forward takes the same differentiable kernels)."""
    params, mask, metrics, grads = port_fused
    rparams, _, rmetrics, rgrads = _port_run(setup, remat=True)
    assert rmetrics == metrics
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(rparams)):
        assert torch.equal(a, b)


def test_fused_step_agrees_with_unfused(setup, port_fused):
    """The kernel backward against autograd through ``softmax_attention``."""
    _, _, metrics, grads = port_fused
    _, _, umetrics, ugrads = _port_run(setup, fused=False, steps=1)
    np.testing.assert_allclose(metrics[0]["loss"], umetrics[0]["loss"], atol=1e-5)
    for g, u in zip(grads, ugrads):
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=1e-3 * float(u.abs().max()) + 1e-7)
