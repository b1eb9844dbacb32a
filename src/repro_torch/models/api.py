"""Model API of the port (counterpart of ``repro.models.api``).

``DecoderModel(cfg, device)`` offers ``init``, ``forward``, ``prefill``,
``decode_step``, ``init_cache`` and ``reset_slots`` for the dense decoder
and the attention-free SSM families. It holds the model's constant
tables on its device (the RoPE frequencies, computed once, so the decode
step never copies from the host).

``cores`` picks the attention core of the decode step and the SSD core
of Mamba2 prefill together: ``"kernel"`` (the served path, the
``repro_torch`` ops) or ``"plain"`` (parity checks on the card).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import rope_freqs


# the families the port builds; the rest come with later slices
FAMILIES = ("dense", "ssm")


class DecoderModel:
    def __init__(self, cfg: ArchConfig, device, *, cores: str = "kernel"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} comes with a later slice "
                f"of the port (ROADMAP A8/A15); the port builds {FAMILIES}"
            )
        if cores not in transformer.CORES:
            raise ValueError(f"cores {cores!r}: one of {transformer.CORES}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.cores = cores
        self.rope_freqs = torch.from_numpy(
            rope_freqs(cfg.resolved_head_dim, cfg.rope_theta)
        ).to(self.device)

    def init(self, generator: torch.Generator) -> dict:
        return transformer.init_params(self.cfg, generator, self.device)

    def forward(self, params, batch: dict):
        """(logits (B, S, vocab), aux) over ``batch["tokens"]`` (B, S)."""
        return transformer.forward(params, self.cfg, batch["tokens"], cores=self.cores)

    def prefill(self, params, batch: dict):
        """(last-position logits (B, vocab), caches) over
        ``batch["tokens"]`` (B, S)."""
        return transformer.prefill(params, self.cfg, batch["tokens"], cores=self.cores)

    def decode_step(self, params, token, caches, pos, active=None, rope_freqs=None):
        return transformer.decode_step(
            params, self.cfg, token, caches, pos, active,
            rope_freqs=self.rope_freqs if rope_freqs is None else rope_freqs,
            cores=self.cores,
        )

    def init_cache(self, batch: int, cache_len: int, device=None):
        return transformer.init_cache(
            self.cfg, batch, cache_len, self.device if device is None else device
        )

    def reset_slots(self, caches, keep):
        return transformer.reset_slots(caches, keep)
