"""SDXL-Turbo's UNet on the port's serving path, on the CPU at toy widths
with SDXL's layer pattern (3 levels, transformer depths (1, 2, 3), text-time
added conditioning): the plain reference's layout is the port's parameter
tree, the port's cold restore and its engine's cold and warm restores give
the reference's outputs in fp32, the config comes from a diffusers
``unet/config.json``, FreeU's factors and the added conditioning reach the
UNet, the ``transformer`` spans and their block counts, and diffusers'
weight names map into the port's tree and back.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

from gpubench import weights
from gpubench.drivers.serve import lora_scaling
from gpubench.drivers.serve_sdxl import bundle_for, statics_for
from gpubench.reference import layout, sdxl
from instantrestore_tpu_torch import convert
from instantrestore_tpu_torch.inference.serving import ServingEngine
from instantrestore_tpu_torch.models import unet as tunet
from instantrestore_tpu_torch.models.freeu import FreeUParams
from instantrestore_tpu_torch.models.restorer import (
    init_restorer_params,
    restore_forward,
    serving_bundle,
)
from instantrestore_tpu_torch.models.unet import UNetConfig, unet_config_from_diffusers
from instantrestore_tpu_torch.utils import profiling

CONFIGS = Path(__file__).resolve().parent.parent / "gpubench" / "configs"
SDXL = json.loads((CONFIGS / "instantrestore-sdxl-turbo-serve.json").read_text())
SD_TURBO = json.loads((CONFIGS / "instantrestore-serve.json").read_text())
B, N = 2, 2
DEPTHS = (1, 2, 3)
# transformer blocks of one UNet at DEPTHS: down 2 x 2 + 2 x 3, mid 3, up 3 x 3 + 3 x 2
BLOCKS = 4 + 6 + 3 + 9 + 6
SHARED = 9 + 6


def tiny_config(depths=DEPTHS) -> dict:
    cfg = copy.deepcopy(SDXL)
    cfg["unet"].update(sample_size=16, block_out_channels=[32, 64, 64],
                       attention_head_dim=[1, 2, 2], cross_attention_dim=16, norm_num_groups=8,
                       transformer_layers_per_block=list(depths), addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=12 + 6 * 8)
    cfg["vae"].update(block_out_channels=[8, 16, 16, 16], norm_num_groups=4)
    cfg["model"].update(resolution=128, n_refs=N, lora_rank_unet=4, lora_rank_vae=4,
                        time_ids=[112, 96, 8, 4, 128, 128], dtype="float32")
    return cfg


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: s for key, v in tree.items() for k, s in _shapes(v, f"{prefix}.{key}").items()}
    if isinstance(tree, list):
        return {k: s for i, v in enumerate(tree) for k, s in _shapes(v, f"{prefix}.{i}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    statics = statics_for(cfg)
    params = weights.materialize(sdxl.restorer_layout(cfg), 7, "cpu",
                                 lora_scaling=lora_scaling(cfg["model"]["lora_rank_unet"]))
    res, lat = cfg["model"]["resolution"], cfg["model"]["resolution"] // 8
    g = torch.Generator().manual_seed(3)
    data = {
        "images": torch.randint(0, 256, (B, res, res, 3), dtype=torch.uint8, generator=g),
        "refs": torch.randint(0, 256, (B, N, res, res, 3), dtype=torch.uint8, generator=g),
        "noise": {k: torch.randn(B, lat, lat, 4, generator=g) for k in ("latent", "diffusion")},
        "cond": {k: torch.randn(B * N, lat, lat, 4, generator=g)
                 for k in ("cond_latent", "cond_diffusion")},
    }
    return cfg, statics, params, data


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's captured K/V of each face's references and its
    restore of the photos against them."""
    cfg, _, params, d = setup
    with torch.no_grad():
        ref = sdxl.Restorer(params, cfg)
        kv = ref.capture(d["refs"], d["cond"]["cond_latent"], d["cond"]["cond_diffusion"])
        out = ref.restore(d["images"], kv, d["noise"]["latent"], d["noise"]["diffusion"])
    return ref, kv, out


def _bundle(setup):
    cfg, statics, params, _ = setup
    return bundle_for(cfg)(params, statics)


def test_layout_is_the_programs_parameter_tree(setup):
    cfg, statics, params, _ = setup
    m = cfg["model"]
    port = init_restorer_params(torch.Generator().manual_seed(0), statics,
                                lora_rank_unet=m["lora_rank_unet"],
                                lora_rank_vae=m["lora_rank_vae"], device="cpu")
    assert _shapes(dict(params, add_time_ids=torch.zeros(1, 6))) == _shapes(port)
    assert port["add_time_ids"].tolist() == [[128, 128, 0, 0, 128, 128]]


def test_cold_restore_matches_the_reference(setup, reference):
    cfg, statics, _, d = setup
    _, kv, r = reference
    assert len(kv) == statics.unet_cfg.num_shared_attn_layers == SHARED
    with torch.no_grad():
        out = restore_forward(_bundle(setup), d["images"].float() / 127.5 - 1,
                              d["refs"].float() / 127.5 - 1, statics=statics, timestep=249,
                              noise={**d["noise"], **d["cond"]})["output_image"]
    assert float((out - r).abs().max()) < 1e-4
    assert float(r.std()) > 0.1  # not a saturated or constant image


def test_engine_cold_restore_matches_the_reference(setup, reference):
    _, statics, _, d = setup
    eng = ServingEngine(_bundle(setup), statics, device="cpu")
    with torch.no_grad():
        out = eng.restore_cold(d["images"], d["refs"], noise={**d["noise"], **d["cond"]})
    assert float((out - reference[2]).abs().max()) < 1e-4


@pytest.mark.parametrize("identity_cache", [True, False], ids=["identity_cache", "kv_rows"])
def test_onboard_and_warm_restore_match_the_reference(setup, reference, identity_cache):
    """The engine's onboarding of each face's references (36 layers at the
    published depths, 15 here) and its warm restore against the reference's
    capture of the same references."""
    _, statics, _, d = setup
    ref = reference[0]
    eng = ServingEngine(_bundle(setup), statics, device="cpu", identity_cache=identity_cache)
    noise = {k: d["cond"][f"cond_{k}"].reshape(B, N, *d["cond"][f"cond_{k}"].shape[1:])
             for k in ("latent", "diffusion")}
    ids = torch.tensor([1, 0])
    with torch.no_grad():
        cache = eng.onboard(d["refs"], noise=noise)
        out = eng.restore(d["images"], ids, noise=d["noise"])
        per_id = [ref.capture(d["refs"][j][None], noise["latent"][j], noise["diffusion"][j])
                  for j in range(B)]
        shared = [tuple(torch.cat([per_id[j][layer][x] for j in ids.tolist()]) for x in (0, 1))
                  for layer in range(SHARED)]
        r = ref.restore(d["images"], shared, d["noise"]["latent"], d["noise"]["diffusion"])
    assert len(cache) == SHARED
    assert float((out - r).abs().max()) < 1e-4


def test_the_reference_sees_the_added_conditioning_and_the_references(setup, reference):
    """The comparison has teeth: other time ids, another pooled embedding or
    another face's references move the reference's output beyond rounding."""
    cfg, _, params, d = setup
    _, kv, r = reference
    args = (d["images"], kv, d["noise"]["latent"], d["noise"]["diffusion"])
    with torch.no_grad():
        other_ids = copy.deepcopy(cfg)
        other_ids["model"]["time_ids"] = [96, 112, 4, 8, 128, 128]
        outs = [sdxl.Restorer(params, other_ids).restore(*args),
                sdxl.Restorer(dict(params, caption_pooled=-params["caption_pooled"]),
                              cfg).restore(*args),
                sdxl.Restorer(params, cfg).restore(d["images"], [(k.flip(0), v.flip(0))
                                                                 for k, v in kv],
                                                   *args[2:])]
    for other in outs:
        assert float((other - r).norm() / r.norm()) > 1e-3


def test_unet_config_from_the_published_configs():
    xl = unet_config_from_diffusers(SDXL["unet"])
    assert xl.transformer_depths == (1, 2, 10)
    assert xl.attention_heads == (5, 10, 20)
    assert xl.num_shared_attn_layers == 36
    assert xl.addition_embed_type == "text_time" and xl.added_text_embed_dim == 1280
    assert xl.cross_attention_dim == 2048 and xl.block_out_channels == (320, 640, 1280)
    turbo = unet_config_from_diffusers(SD_TURBO["unet"])
    assert turbo == UNetConfig() and turbo.num_shared_attn_layers == 9
    assert unet_config_from_diffusers(tiny_config()["unet"]).num_shared_attn_layers == SHARED


@pytest.mark.parametrize("key, value", [("use_linear_projection", False),
                                        ("class_embed_type", "timestep"),
                                        ("addition_embed_type", "text"),
                                        ("mid_block_type", "UNetMidBlock2DSimpleCrossAttn")])
def test_unet_config_refuses_what_the_port_does_not_build(key, value):
    with pytest.raises(ValueError):
        unet_config_from_diffusers(dict(SDXL["unet"], **{key: value}))


def test_freeu_reaches_the_unet_from_the_statics(setup, monkeypatch):
    cfg, statics, _, d = setup
    assert statics.freeu == FreeUParams(s1=0.6, s2=0.4, b1=1.1, b2=1.2)
    seen = []
    real = tunet.apply_freeu

    def recording(idx, hidden, skip, freeu):
        seen.append(freeu)
        return real(idx, hidden, skip, freeu)

    monkeypatch.setattr(tunet, "apply_freeu", recording)
    bundle = _bundle(setup)
    images, refs = d["images"].float() / 127.5 - 1, d["refs"].float() / 127.5 - 1
    noise = {**d["noise"], **d["cond"]}
    with torch.no_grad():
        out = restore_forward(bundle, images, refs, statics=statics, noise=noise)
        assert set(seen) == {statics.freeu}  # the capture's UNet and the restore's
        sd21 = restore_forward(bundle, images, refs, statics=type(statics)(
            **{**statics.__dict__, "freeu": FreeUParams()}), noise=noise)
    assert float((out["output_image"] - sd21["output_image"]).abs().max()) > 1e-3


def test_a_text_time_unet_needs_its_added_conditioning(setup):
    _, statics, params, _ = setup
    x = torch.zeros(1, 16, 16, 4)
    with pytest.raises(ValueError, match="added_cond"):
        tunet.unet_apply(params["unet"], x, torch.tensor([1]), torch.zeros(1, 77, 16),
                         cfg=statics.unet_cfg, compute_dtype=torch.float32)


def test_transformer_spans_and_their_block_counts(setup):
    """Under ``tracing()`` a cold call's record holds the device ms inside
    its ``transformer`` spans (nested in the capture and unet stages, not a
    stage of their own) and their block count: both UNets' blocks."""
    _, statics, _, d = setup
    eng = ServingEngine(_bundle(setup), statics, device="cpu")
    profiling.reset()
    try:
        with torch.no_grad():
            eng.restore_cold(d["images"], d["refs"], noise={**d["noise"], **d["cond"]})
            assert profiling.records() == []
            with profiling.tracing():
                eng.restore_cold(d["images"], d["refs"], noise={**d["noise"], **d["cond"]})
        (rec,) = profiling.records()
    finally:
        profiling.reset()
    assert rec["counts"] == {"transformer": 2 * BLOCKS}
    assert set(rec["nested"]) == {"transformer"} and "transformer" not in rec["stages"]
    assert 0 < rec["nested"]["transformer"] <= rec["stages"]["capture"] + rec["stages"]["unet"]


def test_transformer_ranges_nest_in_the_unet_stages(setup):
    _, statics, _, d = setup
    eng = ServingEngine(_bundle(setup), statics, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            eng.restore_cold(d["images"], d["refs"], noise={**d["noise"], **d["cond"]})
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith("ir/")]
    stages = [(s, e) for n, s, e in ranges if n in ("ir/capture", "ir/unet")]
    inner = [(s, e) for n, s, e in ranges if n == "ir/transformer"]
    assert len(inner) == 2 * (2 + 2 + 1 + 3 + 3)  # Transformer2DModels of both UNets
    assert all(any(s0 <= s <= e <= e0 for s0, e0 in stages) for s, e in inner)


def _diffusers_names(tree, name=""):
    """A layout tree's leaves under diffusers' module names (as peft names
    LoRA factors: ``...lora_A.default.weight``), written out here from the
    layout alone."""
    if isinstance(tree, layout.Leaf):
        return {name: tree}
    if isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        items = [(layout._MODULE_NAMES.get(k, k), v) for k, v in tree.items()]
    out = {}
    for k, v in items:
        if k in ("lora_A", "lora_B"):
            k = f"{k}.default.weight"
        out.update(_diffusers_names(v, f"{name}.{k}" if name else k))
    return out


def test_diffusers_weight_names_map_into_the_tree_and_back():
    """A diffusers-named SDXL UNet state dict (the published depths 1, 2, 10
    at toy widths, with its LoRA factors) maps through
    ``convert.tree_from_state_dict`` onto the port's tree, shape for shape,
    and ``convert.state_dict`` gives every name and tensor back."""
    u = tiny_config((1, 2, 10))["unet"]
    lay = layout.with_lora(sdxl.unet_layout(u), 4, layout.UNET_LORA_TARGETS)
    names = _diffusers_names(lay)
    for key in ("add_embedding.linear_1.weight", "add_embedding.linear_2.bias",
                "up_blocks.0.attentions.0.transformer_blocks.9.attn1.to_q.weight",
                "up_blocks.0.attentions.2.transformer_blocks.9.ff.net.0.proj.lora_A.default.weight",
                "up_blocks.1.attentions.2.transformer_blocks.1.attn1.to_out.0.bias",
                "down_blocks.2.attentions.1.transformer_blocks.9.attn2.to_k.weight",
                "mid_block.attentions.0.transformer_blocks.9.norm3.weight"):
        assert key in names, key
    assert not any(k.startswith("down_blocks.0.attentions") for k in names)
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(leaf.shape, generator=g) for k, leaf in names.items()}
    tree = convert.tree_from_state_dict(sd)
    port = tunet.init_unet_params(torch.Generator().manual_seed(1),
                                  unet_config_from_diffusers(u))
    stripped = {k: v for k, v in _shapes(tree).items() if ".lora_" not in k}
    assert stripped == _shapes(port)
    back = convert.state_dict(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
