"""The plain reference against the program's restore, on the CPU at a tiny
size, on the same seeded weights: the layout the benchmark draws is the
program's parameter tree, and the reference's warm and cold restores give
the program's outputs in fp32."""

import pytest
import torch

from gpubench import weights
from gpubench.drivers.serve import lora_scaling, statics_for
from gpubench.reference import layout, model
from gpubench.tests.tiny import tiny_config
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models.restorer import (
    init_restorer_params,
    restore_forward,
    serving_bundle,
)

B, N = 2, 2


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: s for key, v in tree.items() for k, s in _shapes(v, f"{prefix}.{key}").items()}
    if isinstance(tree, list):
        return {k: s for i, v in enumerate(tree) for k, s in _shapes(v, f"{prefix}.{i}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config(n_refs=N)
    cfg["model"]["dtype"] = "float32"
    statics = statics_for(cfg)
    params = weights.materialize(layout.restorer_layout(cfg), 7, "cpu",
                                 lora_scaling=lora_scaling(cfg["model"]["lora_rank_unet"]))
    res = cfg["model"]["resolution"]
    lat = res // 8
    g = torch.Generator().manual_seed(3)
    data = {
        "images": torch.randint(0, 256, (B, res, res, 3), dtype=torch.uint8, generator=g),
        "refs": torch.randint(0, 256, (B, N, res, res, 3), dtype=torch.uint8, generator=g),
        "noise": {k: torch.randn(B, lat, lat, 4, generator=g) for k in ("latent", "diffusion")},
        "cond": {k: torch.randn(B * N, lat, lat, 4, generator=g)
                 for k in ("cond_latent", "cond_diffusion")},
    }
    return cfg, statics, params, data


def test_layout_is_the_programs_parameter_tree(setup):
    cfg, statics, params, _ = setup
    m = cfg["model"]
    port = init_restorer_params(torch.Generator().manual_seed(0), statics,
                                lora_rank_unet=m["lora_rank_unet"],
                                lora_rank_vae=m["lora_rank_vae"], device="cpu")
    assert _shapes(params) == _shapes(port)


def test_cold_restore_matches_the_program(setup):
    cfg, statics, params, d = setup
    with torch.no_grad():
        out = restore_forward(serving_bundle(params, statics), d["images"].float() / 127.5 - 1,
                              d["refs"].float() / 127.5 - 1, statics=statics, timestep=249,
                              noise={**d["noise"], **d["cond"]})["output_image"]
        ref = model.Restorer(params, cfg)
        kv = ref.capture(d["refs"], d["cond"]["cond_latent"], d["cond"]["cond_diffusion"])
        r = ref.restore(d["images"], kv, d["noise"]["latent"], d["noise"]["diffusion"])
    assert float((out - r).abs().max()) < 1e-4
    assert float(r.std()) > 0.1  # not a saturated or constant image


def test_warm_restore_matches_the_engine(setup):
    """The engine's onboarding (identity cache) and warm restore against the
    reference's capture of each identity's references."""
    cfg, statics, params, d = setup
    eng = ServingEngine(serving_bundle(params, statics), statics, device="cpu")
    onboard_noise = {"latent": d["cond"]["cond_latent"].reshape(B, N, *d["cond"]["cond_latent"].shape[1:]),
                     "diffusion": d["cond"]["cond_diffusion"].reshape(B, N, *d["cond"]["cond_diffusion"].shape[1:])}
    ids = torch.tensor([1, 0])
    with torch.no_grad():
        eng.onboard(d["refs"], noise=onboard_noise)
        out = eng.restore(d["images"], ids, noise=d["noise"])
        ref = model.Restorer(params, cfg)
        per_id = [ref.capture(d["refs"][j][None], onboard_noise["latent"][j],
                              onboard_noise["diffusion"][j]) for j in range(B)]
        shared = [tuple(torch.cat([per_id[j][layer][x] for j in ids.tolist()]) for x in (0, 1))
                  for layer in range(len(per_id[0]))]
        r = ref.restore(d["images"], shared, d["noise"]["latent"], d["noise"]["diffusion"])
    assert float((out - r).abs().max()) < 1e-4


def test_reference_sees_the_lora_and_the_references(setup):
    """The comparison has teeth: dropping the LoRA or the references moves
    the reference's output far beyond rounding."""
    cfg, _, params, d = setup
    with torch.no_grad():
        ref = model.Restorer(params, cfg)
        kv = ref.capture(d["refs"], d["cond"]["cond_latent"], d["cond"]["cond_diffusion"])
        r = ref.restore(d["images"], kv, d["noise"]["latent"], d["noise"]["diffusion"])
        no_lora = model.Restorer(dict(params, unet=model.strip_lora(params["unet"]),
                                      vae=model.strip_lora(params["vae"])), cfg)
        r_lora = no_lora.restore(d["images"], kv, d["noise"]["latent"], d["noise"]["diffusion"])
        kv_other = ref.capture(d["refs"].flip(0), d["cond"]["cond_latent"],
                               d["cond"]["cond_diffusion"])
        r_refs = ref.restore(d["images"], kv_other, d["noise"]["latent"], d["noise"]["diffusion"])
    for other in (r_lora, r_refs):
        assert float((other - r).norm() / r.norm()) > 1e-2
