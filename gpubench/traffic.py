"""The one generator of serving traffic: it reads a mix
(``gpubench/traffic/<mix>.json``) and makes every input of a run from the
seed.

A mix gives ``mode`` (``warm``: faces of onboarded identities, ``cold``:
each face with its own references), ``batch`` (faces a request), and for
``warm`` the number of ``identities`` and the Zipf exponent ``zipf_s`` of
the identity each face belongs to. Every run draws:

- the identities' reference photos (uint8, on the device) and the noise of
  their onboarding;
- a pool of ``pool_batches`` batches of photos (and, cold, of their
  references) in pinned host memory; batch ``i`` of a run is pool entry ``i
  % pool_batches`` with a fresh per-photo byte offset added (mod 256), so no
  two batches of a run carry the same bytes;
- batch ``i``'s identity ids (warm) and its noise, from the seed and ``i``
  alone, so any batch can be made again after the run for the reference.

Photos are uniform random bytes: with random weights the content changes
no work, only the bytes.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from gpubench.weights import generator

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
# generator streams of a run (gpubench/weights.py draws the weights on stream 0)
S_IDENTITY_REFS, S_ONBOARD_NOISE, S_POOL, S_POOL_REFS = 1, 2, 3, 4
S_BATCH_NOISE = 1 << 20  # + batch index


def load_mix(name: str) -> Dict[str, Any]:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % 2**63 for k in (seed, *keys)])


class ServeTraffic:
    """Inputs of one serving run: ``mix`` (a traffic file's dict), ``cfg``
    (a configuration file's dict), ``seed``, on ``device``."""

    def __init__(self, mix: Dict[str, Any], cfg: Dict[str, Any], seed: int, device):
        self.mix, self.seed, self.device = mix, int(seed), torch.device(device)
        m = cfg["model"]
        self.res, self.n_refs = m["resolution"], m["n_refs"]
        self.latent = self.res // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        self.batch_size = mix["batch"]
        self.warm = mix["mode"] == "warm"
        self._pool: Optional[Dict[str, torch.Tensor]] = None
        self._staging: list = []
        if self.warm:
            n = mix["identities"]
            ranks = np.arange(1, n + 1, dtype=np.float64)
            p = ranks ** -float(mix["zipf_s"])
            # which identity holds which popularity rank is drawn from the seed
            self.popularity = _rng(self.seed, 11).permutation(n)
            self.p = p / p.sum()

    # ------------------------------------------------------------ identities

    def identity_refs(self) -> torch.Tensor:
        """uint8 [I, N, R, R, 3] on the device."""
        shape = (self.mix["identities"], self.n_refs, self.res, self.res, 3)
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=self.device,
                             generator=generator(self.seed, self.device, S_IDENTITY_REFS))

    def onboard_noise(self) -> Dict[str, torch.Tensor]:
        """{latent, diffusion} [I, N, h, w, 4] on the device."""
        g = generator(self.seed, self.device, S_ONBOARD_NOISE)
        shape = (self.mix["identities"], self.n_refs, self.latent, self.latent, 4)
        return {k: torch.randn(shape, generator=g, device=self.device)
                for k in ("latent", "diffusion")}

    # ------------------------------------------------------------ batches

    def _make_pool(self) -> Dict[str, torch.Tensor]:
        p, b, r = self.mix["pool_batches"], self.batch_size, self.res
        pin = self.device.type == "cuda"
        pool = {"images": torch.randint(0, 256, (p, b, r, r, 3), dtype=torch.uint8,
                                        device=self.device,
                                        generator=generator(self.seed, self.device, S_POOL))}
        if not self.warm:
            pool["refs"] = torch.randint(0, 256, (p, b, self.n_refs, r, r, 3), dtype=torch.uint8,
                                         device=self.device,
                                         generator=generator(self.seed, self.device, S_POOL_REFS))
        pool = {k: v.cpu().pin_memory() if pin else v.cpu() for k, v in pool.items()}
        # two pinned staging buffers, used in turn: batch i + 1 is written
        # while batch i is served
        self._staging = [{k: torch.empty_like(v[0]) for k, v in pool.items()} for _ in range(2)]
        if pin:
            self._staging = [{k: v.pin_memory() for k, v in s.items()} for s in self._staging]
        return pool

    def ids(self, i: int) -> torch.Tensor:
        """Batch ``i``'s identity ids [B] (int64, on the host)."""
        ranks = _rng(self.seed, 12, i).choice(len(self.p), size=self.batch_size, p=self.p)
        return torch.from_numpy(self.popularity[ranks].astype(np.int64))

    def noise(self, i: int) -> Dict[str, torch.Tensor]:
        """Batch ``i``'s noise on the device: {latent, diffusion} [B, h, w, 4],
        cold also {cond_latent, cond_diffusion} [B * N, h, w, 4]."""
        g = generator(self.seed, self.device, S_BATCH_NOISE + i)
        b, lat = self.batch_size, self.latent
        keys = [("latent", b), ("diffusion", b)]
        if not self.warm:
            keys += [("cond_latent", b * self.n_refs), ("cond_diffusion", b * self.n_refs)]
        return {k: torch.randn((n, lat, lat, 4), generator=g, device=self.device)
                for k, n in keys}

    def batch(self, i: int, *, fresh: bool = False) -> Dict[str, Any]:
        """Batch ``i``: {images uint8 [B, R, R, 3] (pinned on a card), refs
        uint8 [B, N, R, R, 3] (cold), ids [B] (warm), noise}. Without
        ``fresh`` the photos are written into one of the two staging
        buffers, which later batches overwrite."""
        if self._pool is None:
            self._pool = self._make_pool()
        rng = _rng(self.seed, 13, i)
        slot = i % self.mix["pool_batches"]
        out: Dict[str, Any] = {}
        stage = self._staging[i % 2]
        for k, pool in self._pool.items():
            src = pool[slot]
            offset = torch.from_numpy(rng.integers(0, 256, size=src.shape[:-3], dtype=np.uint8))
            dst = torch.empty_like(src) if fresh else stage[k]
            torch.add(src, offset.reshape(*offset.shape, 1, 1, 1), out=dst)
            out[k] = dst
        if self.warm:
            out["ids"] = self.ids(i)
        out["noise"] = self.noise(i)
        return out
