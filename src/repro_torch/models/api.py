"""Model API of the port (counterpart of ``repro.models.api``).

``DecoderModel(cfg, device)`` offers ``init``, ``forward``, ``prefill``,
``decode_step``, ``init_cache`` and ``reset_slots`` for every decoder
family of the reference: dense (global and sliding-window attention),
MoE (attention with the grouped capacity dispatch), the attention-free
SSM, the hybrid (Mamba2 with zamba2's shared attention block) and the
VLM (a dense decoder whose prefill takes ``batch["prefix_embeds"]``, the
stub frontend's image embeddings, in front of the tokens; decode has no
prefix). ``grow_caches`` stays a function of ``models/transformer.py``,
as in the reference, whose ``Model`` does not expose it.

The model holds its constant tables on its device, computed once so the
decode step never copies from the host: the RoPE frequencies at the
layers' head dim (``rope_freqs``) and, with a shared block, at its own
(``shared_freqs``). ``rope_tables`` gives them as keyword arguments of
``forward``, ``prefill`` and ``decode_step``: a traced call passes that
dict as an input (a tensor the traced function closes over is not a
fake tensor) and unpacks it into the call.

``cores`` picks the attention core of the decode step and the SSD core
of Mamba2 prefill together (attention prefill has one core): ``"kernel"`` (the served path, the
``repro_torch`` ops) or ``"plain"`` (parity checks on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import rope_freqs


# the families the port builds; the rest come with later slices
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


class DecoderModel:
    def __init__(self, cfg: ArchConfig, device, *, cores: str = "kernel"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} comes with a later slice "
                f"of the port (ROADMAP A15); the port builds {FAMILIES}"
            )
        if cores not in transformer.CORES:
            raise ValueError(f"cores {cores!r}: one of {transformer.CORES}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.cores = cores
        self.rope_freqs = torch.from_numpy(
            rope_freqs(cfg.resolved_head_dim, cfg.rope_theta)
        ).to(self.device)
        self.shared_freqs = None
        if transformer.has_shared_attn(cfg):
            self.shared_freqs = torch.from_numpy(
                rope_freqs(transformer.shared_head_dim(cfg), cfg.rope_theta)
            ).to(self.device)

    @property
    def rope_tables(self) -> dict:
        """The RoPE tables as keyword arguments of the model's calls."""
        tables = {"rope_freqs": self.rope_freqs}
        if self.shared_freqs is not None:
            tables["shared_freqs"] = self.shared_freqs
        return tables

    def _tables(self, rope_freqs, shared_freqs) -> dict:
        return {"rope_freqs": self.rope_freqs if rope_freqs is None else rope_freqs,
                "shared_freqs": (self.shared_freqs if shared_freqs is None
                                 else shared_freqs)}

    def init(self, generator: torch.Generator) -> dict:
        return transformer.init_params(self.cfg, generator, self.device)

    def forward(self, params, batch: dict, rope_freqs=None, shared_freqs=None):
        """(logits (B, P + S, vocab), aux) over ``batch["prefix_embeds"]``
        (B, P, d_model), if given, and ``batch["tokens"]`` (B, S). The
        tables default to the model's (``rope_tables``)."""
        return transformer.forward(
            params, self.cfg, batch["tokens"], batch.get("prefix_embeds"),
            cores=self.cores, **self._tables(rope_freqs, shared_freqs))

    def prefill(self, params, batch: dict, rope_freqs=None, shared_freqs=None):
        """(last-position logits (B, vocab), caches) over the batch, as in
        ``forward``."""
        return transformer.prefill(
            params, self.cfg, batch["tokens"], batch.get("prefix_embeds"),
            cores=self.cores, **self._tables(rope_freqs, shared_freqs))

    def decode_step(self, params, token, caches, pos, active=None, rope_freqs=None,
                    shared_freqs=None):
        return transformer.decode_step(
            params, self.cfg, token, caches, pos, active, cores=self.cores,
            **self._tables(rope_freqs, shared_freqs))

    def init_cache(self, batch: int, cache_len: int, device=None):
        return transformer.init_cache(
            self.cfg, batch, cache_len, self.device if device is None else device
        )

    def reset_slots(self, caches, keep):
        return transformer.reset_slots(caches, keep)
