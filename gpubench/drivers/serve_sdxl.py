"""A serving cell of an SDXL-class configuration
(``instantrestore-sdxl-turbo-serve``): ``gpubench/drivers/serve.py``'s run
(set-up, window, latencies, reservoir and the two ``correct`` numbers, as
that module's docstring defines them) with this configuration's program
statics, weight layout, bundle, plain reference and flop count.

``serve.py`` reads those through its module names ``statics_for``,
``restorer_layout``, ``serving_bundle``, ``Restorer`` and ``flops``; they
are bound to this module's for the run only and restored after it:

- ``statics_for``: ``serve.statics_for``'s VAE and model settings with the
  UNet built by the port's ``unet_config_from_diffusers`` from the
  configuration's ``unet`` block (per-level depth, text-time added
  conditioning) and FreeU from ``model.freeu``;
- ``restorer_layout`` and ``Restorer``: ``gpubench/reference/sdxl.py``'s;
- ``serving_bundle``: the port's, given the configuration's ``model.time_ids``
  as the bundle's ``add_time_ids``;
- ``flops``: ``gpubench/flops_sdxl.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import torch

from gpubench import flops_sdxl
from gpubench.drivers import serve
from gpubench.drivers.serve import RunContext  # noqa: F401  (gpubench/run.py builds it)
from gpubench.reference import sdxl
from instantrestore_tpu_torch.models.freeu import FreeUParams
from instantrestore_tpu_torch.models.restorer import RestorerStatics, serving_bundle
from instantrestore_tpu_torch.models.unet import unet_config_from_diffusers

_SD_STATICS = serve.statics_for


def statics_for(cfg: Dict[str, Any]) -> RestorerStatics:
    """The program's statics for an SDXL-class configuration file."""
    return dataclasses.replace(_SD_STATICS(cfg), unet_cfg=unet_config_from_diffusers(cfg["unet"]),
                               freeu=FreeUParams(**cfg["model"]["freeu"]))


def bundle_for(cfg: Dict[str, Any]):
    """``serving_bundle`` over a drawn tree plus the configuration's time ids."""
    def bundle(params: Dict[str, Any], statics: RestorerStatics) -> Dict[str, Any]:
        ids = torch.tensor([cfg["model"]["time_ids"]], dtype=torch.long,
                           device=params["caption_pooled"].device)
        return serving_bundle(dict(params, add_time_ids=ids), statics)
    return bundle


@contextlib.contextmanager
def bound(cfg: Dict[str, Any]):
    """``serve.py``'s names bound to this configuration's, then restored."""
    names = {"statics_for": statics_for, "restorer_layout": sdxl.restorer_layout,
             "serving_bundle": bundle_for(cfg), "Restorer": sdxl.Restorer, "flops": flops_sdxl}
    old = {k: getattr(serve, k) for k in names}
    for k, v in names.items():
        setattr(serve, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(serve, k, v)


def run(ctx: RunContext) -> Dict[str, Any]:
    with bound(ctx.config):
        return serve.run(ctx)
