"""Plain PyTorch reference of InstantRestore's restore on SDXL-Turbo's UNet
(fp32, NCHW), beside ``model.py``'s on SD-Turbo's.

Written from the published description, not from the program under test:
diffusers' UNet2DConditionModel for SDXL-Turbo's ``unet/config.json``
(3 levels, ``transformer_layers_per_block`` [1, 2, 10], linear projections,
``addition_embed_type`` "text_time"), its AutoencoderKL (the SD VAE's
layers) and InstantRestore's shared attention. It reuses ``layout.py`` and
``model.py`` (the resnets, attentions, norms, the VAE, the schedule and the
capture and restore flow) and adds only what SDXL needs:

- the layout: every Transformer2DModel its level's depth (the mid block
  the last level's, the up blocks in reverse, as diffusers'
  ``reversed_transformer_layers_per_block``), ``add_embedding`` (linear
  ``projection_class_embeddings_input_dim`` -> 4 * block_out_channels[0],
  SiLU, linear) and the pooled prompt embedding ``caption_pooled`` [1, D]
  beside ``caption_enc``;
- the added conditioning: add_embedding(concat(pooled, sinusoid of
  ``addition_time_embed_dim`` of each of the 6 time ids)) added to the time
  embedding (diffusers' ``add_time_proj`` and ``add_embedding``);
- FreeU from the configuration (``model.freeu``), on up blocks 0 and 1;
- InstantRestore's shared layers on this UNet: the self-attention of every
  transformer block of the cross-attention up blocks, in traversal order
  (36 for the published config), each with its own captured K/V.

Departures from diffusers are ``model.py``'s: ``layout.QK_GAIN`` on every
attention's queries and keys, flip_sin_to_cos and a zero frequency shift
taken as the config gives them, FreeU's FFT skipped on ``meta``. The time
ids are the configuration's ``model.time_ids``, not the program's.
It imports torch and the other reference modules only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from gpubench.reference import layout, model
from gpubench.reference.layout import Leaf

ADDED_TIME_IDS = 6  # original size (h, w), crop top-left (y, x), target size (h, w)


# ---------------------------------------------------------------- layout


def depths(u: Dict[str, Any]) -> List[int]:
    """Transformer blocks a Transformer2DModel at each level (down order)."""
    d = u.get("transformer_layers_per_block", 1)
    return [d] * len(u["block_out_channels"]) if isinstance(d, int) else list(d)


def pooled_dim(u: Dict[str, Any]) -> int:
    """Width of the pooled prompt embedding the added conditioning takes."""
    return u["projection_class_embeddings_input_dim"] - ADDED_TIME_IDS * u["addition_time_embed_dim"]


def _deepen(transformer: Dict[str, Any], depth: int, ch: int, ctx: int) -> None:
    """A one-block transformer layout made ``depth`` blocks deep (fresh leaves)."""
    transformer["transformer_blocks"] += [layout._transformer(ch, ctx)["transformer_blocks"][0]
                                          for _ in range(depth - 1)]


def unet_layout(u: Dict[str, Any]) -> Dict[str, Any]:
    """SDXL's UNet2DConditionModel (``u``: its config.json keys)."""
    p = layout.unet_layout(u)
    chs, ctx, d = u["block_out_channels"], u["cross_attention_dim"], depths(u)
    for i, bp in enumerate(p["down_blocks"]):
        for t in bp.get("attentions", []):
            _deepen(t, d[i], chs[i], ctx)
    _deepen(p["mid_block"]["attentions"][0], d[-1], chs[-1], ctx)
    for i, bp in enumerate(p["up_blocks"]):
        for t in bp.get("attentions", []):
            _deepen(t, d[-1 - i], chs[-1 - i], ctx)
    temb = chs[0] * 4
    p["add_embedding"] = {"linear_1": layout._dense(u["projection_class_embeddings_input_dim"],
                                                    temb),
                          "linear_2": layout._dense(temb, temb)}
    return p


def restorer_layout(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``layout.restorer_layout`` with this UNet (its LoRA on the same
    targets) and the pooled prompt embedding ``caption_pooled``."""
    out = layout.restorer_layout(cfg)
    out["unet"] = layout.with_lora(unet_layout(cfg["unet"]), cfg["model"]["lora_rank_unet"],
                                   layout.UNET_LORA_TARGETS)
    out["caption_pooled"] = Leaf("embedding", (1, pooled_dim(cfg["unet"])))
    return out


# ---------------------------------------------------------------- UNet


def transformer(p, x, ctx, heads: int, u: Dict[str, Any], s: float, modes: List[Dict[str, Any]]):
    """``model.transformer`` with each block's own self-attention mode."""
    b, c, hh, ww = x.shape
    h = model.gnorm(p["norm"], x, u["norm_num_groups"], u["transformer_norm_eps"])
    h = model.linear(p["proj_in"], h.flatten(2).transpose(1, 2), s)
    for bp, mode in zip(p["transformer_blocks"], modes, strict=True):
        h = h + model.self_attention(bp["attn1"], model.lnorm(bp["norm1"], h), heads, s, mode)
        h = h + model.cross_attention(bp["attn2"], model.lnorm(bp["norm2"], h), ctx, heads, s)
        a, gate = model.linear(bp["ff"]["net_0_proj"], model.lnorm(bp["norm3"], h),
                               s).chunk(2, dim=-1)
        h = h + model.linear(bp["ff"]["net_2"], a * F.gelu(gate), s)
    h = model.linear(p["proj_out"], h, s)
    return h.transpose(1, 2).reshape(b, c, hh, ww) + x


def unet(p, x, t, ctx, pooled, time_ids, u: Dict[str, Any], freeu: Dict[str, float], s: float,
         shared: Optional[List] = None, adain: bool = False, train_input: bool = True,
         capture: Optional[List] = None):
    """eps [B, 4, h, w] from x [B, 4, h, w], t [B], ctx [B, T, C], pooled
    [B, D], time_ids [B, 6]. ``shared``: one (rk, rv) per shared layer;
    ``capture``: a list that receives each shared layer's (k, v)."""
    groups, eps = u["norm_num_groups"], u["norm_eps"]
    heads, chs = u["attention_head_dim"], u["block_out_channels"]
    te, ae = p["time_embedding"], p["add_embedding"]
    temb = model.linear(te["linear_2"], F.silu(model.linear(te["linear_1"],
                                                             model.time_embedding(t, chs[0]))))
    time = model.time_embedding(time_ids.flatten(), u["addition_time_embed_dim"])
    added = torch.cat([pooled, time.reshape(pooled.shape[0], -1)], dim=-1)
    temb = temb + model.linear(ae["linear_2"], F.silu(model.linear(ae["linear_1"], added)))
    scales = {0: (freeu["b1"], freeu["s1"]), 1: (freeu["b2"], freeu["s2"])}

    def plain(tp):
        return [{}] * len(tp["transformer_blocks"])

    x = model.conv(p["conv_in"], x, s)
    skips = [x]
    for i, bp in enumerate(p["down_blocks"]):
        for j, rp in enumerate(bp["resnets"]):
            x = model.resnet(rp, x, temb, groups, eps, s)
            if "attentions" in bp:
                tp = bp["attentions"][j]
                x = transformer(tp, x, ctx, heads[i], u, s, plain(tp))
            skips.append(x)
        if "downsamplers" in bp:
            x = model.conv(bp["downsamplers"][0]["conv"], x, s, stride=2)
            skips.append(x)
    mp = p["mid_block"]
    x = model.resnet(mp["resnets"][0], x, temb, groups, eps, s)
    x = transformer(mp["attentions"][0], x, ctx, heads[-1], u, s, plain(mp["attentions"][0]))
    x = model.resnet(mp["resnets"][1], x, temb, groups, eps, s)
    layer = 0
    for i, bp in enumerate(p["up_blocks"]):
        for j, rp in enumerate(bp["resnets"]):
            skip = skips.pop()
            if i in scales:
                b_scale, s_scale = scales[i]
                half = x.shape[1] // 2
                x = torch.cat([x[:, :half] * b_scale, x[:, half:]], dim=1)
                skip = model.fourier_filter(skip, s_scale)
            x = model.resnet(rp, torch.cat([x, skip], dim=1), temb, groups, eps, s)
            if "attentions" in bp:
                tp = bp["attentions"][j]
                depth = len(tp["transformer_blocks"])
                modes: List[Dict[str, Any]] = [{} for _ in range(depth)]
                for k, mode in enumerate(modes):
                    if capture is not None:
                        mode["capture"] = capture
                    if shared is not None:
                        mode.update(refs=shared[layer + k], adain=adain, train_input=train_input)
                x = transformer(tp, x, ctx, heads[len(chs) - 1 - i], u, s, modes)
                layer += depth
        if "upsamplers" in bp:
            x = model.conv(bp["upsamplers"][0]["conv"],
                           F.interpolate(x, scale_factor=2.0, mode="nearest"), s)
    x = F.silu(model.gnorm(p["conv_norm_out"], x, groups, eps))
    return model.conv(p["conv_out"], x, s)


# ---------------------------------------------------------------- the restore


class Restorer(model.Restorer):
    """``model.Restorer``'s capture and restore on this UNet."""

    def __init__(self, params: Dict[str, Any], cfg: Dict[str, Any]):
        super().__init__(params, cfg)
        self.freeu = cfg["model"]["freeu"]
        self.time_ids = cfg["model"]["time_ids"]

    def _added(self, b: int, device):
        pooled = self.p["caption_pooled"].float().to(device).expand(b, -1)
        ids = torch.tensor(self.time_ids, dtype=torch.float64, device=device).expand(b, -1)
        return pooled, ids

    def capture(self, refs: torch.Tensor, latent_noise, diffusion_noise) -> List:
        """refs uint8 [B, N, H, W, 3], noise [B*N, h, w, 4] -> per shared
        layer (k, v) [B, N, H, S, d]."""
        b, n = refs.shape[:2]
        abar = model.alphas_cumprod(refs.device)
        mean, logvar = model.vae_encode(self.orig_vae, model.to_unit(refs.flatten(0, 1)), self.v,
                                        1.0)
        z = (mean + torch.exp(0.5 * logvar) * model.nchw(latent_noise)) * self.sf
        t = torch.full((b * n,), self.m["cond_timestep"], dtype=torch.long, device=z.device)
        a = abar[t][:, None, None, None]
        zt = a.sqrt() * z + (1 - a).sqrt() * model.nchw(diffusion_noise)
        kv: List = []
        unet(self.orig_unet, zt, t, self._ctx(b * n, z.device), *self._added(b * n, z.device),
             self.u, self.freeu, 1.0, capture=kv)
        return [(k.reshape(b, n, *k.shape[1:]), v.reshape(b, n, *v.shape[1:])) for k, v in kv]

    def restore(self, images: torch.Tensor, shared: List, latent_noise, diffusion_noise):
        """images uint8 [B, H, W, 3], shared from ``capture`` -> the restored
        images [B, H, W, 3] in [-1, 1]."""
        b = images.shape[0]
        abar = model.alphas_cumprod(images.device)
        mean, logvar = model.vae_encode(self.p["vae"], model.to_unit(images), self.v, self.s_vae)
        z = (mean + torch.exp(0.5 * logvar) * model.nchw(latent_noise)) * self.sf
        t = torch.full((b,), self.m["timestep"], dtype=torch.long, device=z.device)
        a = abar[t][:, None, None, None]
        zt = a.sqrt() * z + (1 - a).sqrt() * model.nchw(diffusion_noise)
        eps = unet(self.p["unet"], zt, t, self._ctx(b, z.device), *self._added(b, z.device),
                   self.u, self.freeu, self.s_unet, shared=shared, adain=self.m["use_adain"],
                   train_input=self.m["train_input"])
        x0 = (zt - (1 - a).sqrt() * eps) / a.sqrt()
        out = model.vae_decode(self.p["vae"], x0 / self.sf, self.v, self.s_vae)
        return out.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
