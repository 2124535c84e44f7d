"""The capture branch with LoRA'd capture networks: explicit ``original_unet``
/ ``original_vae`` trees that carry LoRA leaves (a ``train_reference_networks``
bundle, or a FULL checkpoint trained with it) take their LoRA at
``reference_lora_scaling`` (0.5, alpha 8 over rank 16) in
``get_conditioning_kv``, as the JAX package's capture does, and not at the
default 1.0. The port vs the JAX package at tiny widths, fp32, on the CPU;
JAX's reference noise is redrawn with its own helpers (``cond_draws``).

Tolerance: 1e-4 max-abs on the captured K/V (as ``tests/test_torch_cold.py``
holds cached K/V) and 1e-3 on the decoded references (its image tolerance).
The same bundle at scaling 1.0 lies far outside it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantrestore_tpu.models import restorer as jrest
from instantrestore_tpu.models import scheduler as jsched
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.models import restorer as trest
from instantrestore_tpu_torch.models import scheduler as tsched

from test_torch_cold import J_STATICS, N, RES, T_STATICS, cond_draws
from test_torch_serving import random_tree

B = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: beside the other test workers, more threads only
    contend (as ``tests/test_torch_coach.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def capture():
    """A JAX bundle with LoRA'd capture networks, its converted twin, the
    references and JAX's capture (K/V and decoded references) with its
    noise."""
    statics = dataclasses.replace(J_STATICS, train_reference_networks=True)
    params = random_tree(
        lambda k: jrest.init_restorer_params(k, statics, lora_rank_unet=4, lora_rank_vae=4),
        jax.random.PRNGKey(0))
    assert "lora_A" in params["original_unet"]["conv_out"]
    rng = np.random.default_rng(5)
    conds = rng.uniform(-1, 1, (B, N, RES, RES, 3)).astype(np.float32)
    valid = np.array([N, 1], np.int32)
    key = jax.random.PRNGKey(9)
    kv, decoded = jax.jit(lambda p, c, v, r: jrest.get_conditioning_kv(
        p, c, v, r, statics=J_STATICS, alphas_cumprod=jsched.make_alphas_cumprod(),
        decode_conditions=True))(params, jnp.asarray(conds), jnp.asarray(valid), key)
    noise = {k: torch.from_numpy(np.array(v)) for k, v in cond_draws(key, B, N).items()}
    return dict(torch=convert.from_jax_tree(jax.tree_util.tree_map(np.asarray, params)),
                conds=conds, valid=valid, noise=noise, kv=[tuple(map(np.asarray, p)) for p in kv],
                decoded=np.asarray(decoded))


def _port_capture(capture, statics):
    with torch.no_grad():
        return trest.get_conditioning_kv(
            capture["torch"], torch.from_numpy(capture["conds"]),
            torch.from_numpy(capture["valid"]), statics=statics,
            alphas_cumprod=tsched.make_alphas_cumprod(), noise=capture["noise"],
            decode_conditions=True)


def test_capture_with_lora_originals_matches_jax(capture):
    kv, decoded = _port_capture(capture, T_STATICS)
    assert len(kv) == len(capture["kv"]) == 9
    for (k, v), (rk, rv) in zip(kv, capture["kv"]):
        np.testing.assert_allclose(k.numpy(), rk, rtol=0, atol=1e-4)
        np.testing.assert_allclose(v.numpy(), rv, rtol=0, atol=1e-4)
    np.testing.assert_allclose(decoded.numpy(), capture["decoded"], rtol=0, atol=1e-3)


def test_capture_lora_scaling_is_read_from_the_statics(capture):
    """At scaling 1.0 the LoRA'd capture differs far beyond the tolerance;
    at 0.0 it is the capture of the stripped originals."""
    kv1, _ = _port_capture(capture, dataclasses.replace(T_STATICS, reference_lora_scaling=1.0))
    assert max(float(np.abs(k.numpy() - rk).max()) for (k, _), (rk, _) in
               zip(kv1, capture["kv"])) > 1e-2
    kv0, _ = _port_capture(capture, dataclasses.replace(T_STATICS, reference_lora_scaling=0.0))
    stripped = dict(capture, torch={**capture["torch"], **{
        k: trest.strip_lora(capture["torch"][k]) for k in ("original_unet", "original_vae")}})
    kvs, _ = _port_capture(stripped, T_STATICS)
    for (k0, v0), (ks, vs) in zip(kv0, kvs):
        torch.testing.assert_close(k0, ks, rtol=0, atol=0)
        torch.testing.assert_close(v0, vs, rtol=0, atol=0)
