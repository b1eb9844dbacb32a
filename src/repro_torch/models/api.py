"""Model API of the port (counterpart of ``repro.models.api``).

``DecoderModel(cfg, device)`` offers ``init``, ``decode_step``,
``init_cache`` and ``reset_slots`` for the dense decoder family. It
holds the model's constant tables on its device (the RoPE frequencies,
computed once, so the decode step never copies from the host).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import rope_freqs


class DecoderModel:
    def __init__(self, cfg: ArchConfig, device, *, attention: str = "kernel"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} comes with a later slice "
                f"of the port (ROADMAP A8/A15); this slice serves dense "
                f"decoders"
            )
        if attention not in transformer.ATTENTION:
            raise ValueError(f"attention {attention!r}: one of "
                             f"{sorted(transformer.ATTENTION)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.attention = attention
        self.rope_freqs = torch.from_numpy(
            rope_freqs(cfg.resolved_head_dim, cfg.rope_theta)
        ).to(self.device)

    def init(self, generator: torch.Generator) -> dict:
        return transformer.init_params(self.cfg, generator, self.device)

    def decode_step(self, params, token, caches, pos, active=None, rope_freqs=None):
        return transformer.decode_step(
            params, self.cfg, token, caches, pos, active,
            rope_freqs=self.rope_freqs if rope_freqs is None else rope_freqs,
            attention=self.attention,
        )

    def init_cache(self, batch: int, cache_len: int, device=None):
        return transformer.init_cache(
            self.cfg, batch, cache_len, self.device if device is None else device
        )

    def reset_slots(self, caches, keep):
        return transformer.reset_slots(caches, keep)
