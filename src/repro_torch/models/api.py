"""Model API of the port (counterpart of ``repro.models.api``).

``for_config(cfg, device)`` builds the model of ``cfg``'s family.
``DecoderModel(cfg, device)`` offers ``init``, ``forward``, ``prefill``,
``decode_step``, ``init_cache`` and ``reset_slots`` for every decoder
family of the reference: dense (global and sliding-window attention),
MoE (attention with the grouped capacity dispatch), the attention-free
SSM, the hybrid (Mamba2 with zamba2's shared attention block) and the
VLM (a dense decoder whose prefill takes ``batch["prefix_embeds"]``, the
stub frontend's image embeddings, in front of the tokens; decode has no
prefix). ``grow_caches`` stays a function of ``models/transformer.py``,
as in the reference, whose ``Model`` does not expose it.
``EncDecModel`` offers the same calls for the enc-dec family, whose
batches carry ``batch["frames"]``.

The model holds its constant tables on its device, computed once so the
decode step never copies from the host: the RoPE frequencies at the
layers' head dim (``rope_freqs``) and, with a shared block, at its own
(``shared_freqs``). ``rope_tables`` gives them as keyword arguments of
``forward``, ``prefill`` and ``decode_step``: a traced call passes that
dict as an input (a tensor the traced function closes over is not a
fake tensor) and unpacks it into the call.

``forward``, ``prefill`` and ``decode_step`` take ``constrain(x, tag)``
(default None), called at the reference's sharding sites
(``launch/mesh.ShardingCtx.constrain`` in a sharded step; with None each
traced step is what it was without the hook). ``supports_shape`` and
``input_specs`` are the reference's; the specs are ``meta`` tensors,
the counterpart of its ``ShapeDtypeStruct``.

``cores`` picks the attention core of the decode step and the SSD core
of Mamba2 prefill together (attention prefill has one core): ``"kernel"`` (the served path, the
``repro_torch`` ops) or ``"plain"`` (parity checks on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import rope_freqs


# the families the port builds: the decoder ones (DecoderModel) and the
# enc-dec one (EncDecModel)
DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
FAMILIES = (*DECODER_FAMILIES, "audio")


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


def supports_shape(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch; long_500k needs sub-quadratic"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class DecoderModel:
    def __init__(self, cfg: ArchConfig, device, *, cores: str = "kernel"):
        if cfg.family not in DECODER_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not a decoder family "
                f"{DECODER_FAMILIES}; for_config builds its model"
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

    def supports_shape(self, shape: ShapeSpec) -> tuple[bool, str]:
        return supports_shape(self.cfg, shape)

    def input_specs(self, shape: ShapeSpec) -> dict:
        """The step's batch as ``meta`` tensors (reference ``api.py:89``):
        decode takes one token a slot; a VLM's text is shortened by its
        prefix, whose embeddings it takes; train adds the labels."""
        cfg = self.cfg
        B = shape.global_batch
        if shape.kind == "decode":
            return {"tokens": _spec((B, 1), torch.int32)}
        S = shape.seq_len
        specs: dict = {}
        if cfg.n_prefix_tokens:
            S = max(S - cfg.n_prefix_tokens, 1)
            specs["prefix_embeds"] = _spec((B, cfg.n_prefix_tokens, cfg.d_model),
                                           getattr(torch, cfg.dtype))
        specs["tokens"] = _spec((B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        return specs

    def forward(self, params, batch: dict, rope_freqs=None, shared_freqs=None,
                remat: bool = False, constrain=None):
        """(logits (B, P + S, vocab), aux) over ``batch["prefix_embeds"]``
        (B, P, d_model), if given, and ``batch["tokens"]`` (B, S). The
        tables default to the model's (``rope_tables``); ``remat``
        recomputes each period in the backward pass."""
        return transformer.forward(
            params, self.cfg, batch["tokens"], batch.get("prefix_embeds"),
            cores=self.cores, remat=remat, constrain=constrain,
            **self._tables(rope_freqs, shared_freqs))

    def prefill(self, params, batch: dict, rope_freqs=None, shared_freqs=None,
                constrain=None):
        """(last-position logits (B, vocab), caches) over the batch, as in
        ``forward``."""
        return transformer.prefill(
            params, self.cfg, batch["tokens"], batch.get("prefix_embeds"),
            cores=self.cores, constrain=constrain,
            **self._tables(rope_freqs, shared_freqs))

    def decode_step(self, params, token, caches, pos, active=None, rope_freqs=None,
                    shared_freqs=None, constrain=None):
        return transformer.decode_step(
            params, self.cfg, token, caches, pos, active, cores=self.cores,
            constrain=constrain, **self._tables(rope_freqs, shared_freqs))

    def init_cache(self, batch: int, cache_len: int, device=None):
        return transformer.init_cache(
            self.cfg, batch, cache_len, self.device if device is None else device
        )

    def reset_slots(self, caches, keep):
        return transformer.reset_slots(caches, keep)


class EncDecModel:
    """The enc-dec family (``models/encdec.py``; reference ``api.py:110-157``):
    ``batch["frames"]`` (B, S_enc, d_model) are the stub frontend's frame
    embeddings. Trained and run through the model API; the engine serves
    decoder-only archs, as the reference's does."""

    def __init__(self, cfg: ArchConfig, device, *, cores: str = "kernel"):
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not enc-dec")
        if cores not in transformer.CORES:
            raise ValueError(f"cores {cores!r}: one of {transformer.CORES}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.cores = cores
        self.rope_freqs = torch.from_numpy(
            rope_freqs(cfg.resolved_head_dim, cfg.rope_theta)).to(self.device)

    def init(self, generator: torch.Generator) -> dict:
        return encdec.init_params(self.cfg, generator, self.device)

    @property
    def rope_tables(self) -> dict:
        return {"rope_freqs": self.rope_freqs}

    def supports_shape(self, shape: ShapeSpec) -> tuple[bool, str]:
        return supports_shape(self.cfg, shape)

    def input_specs(self, shape: ShapeSpec) -> dict:
        """The step's batch as ``meta`` tensors (reference ``api.py:143``):
        the stub frontend's frames at ``seq_len // enc_len_ratio``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": _spec((B, 1), torch.int32)}
        specs = {
            "tokens": _spec((B, S), torch.int32),
            "frames": _spec((B, max(S // cfg.enc_len_ratio, 1), cfg.d_model),
                            getattr(torch, cfg.dtype)),
        }
        if shape.kind == "train":
            specs["labels"] = _spec((B, S), torch.int32)
        return specs

    def forward(self, params, batch: dict, rope_freqs=None, remat: bool = False,
                constrain=None):
        return encdec.forward(
            params, self.cfg, batch["tokens"], batch["frames"], remat=remat,
            rope_freqs=self.rope_freqs if rope_freqs is None else rope_freqs,
            constrain=constrain)

    def prefill(self, params, batch: dict, rope_freqs=None, constrain=None):
        return encdec.prefill(
            params, self.cfg, batch["tokens"], batch["frames"],
            rope_freqs=self.rope_freqs if rope_freqs is None else rope_freqs,
            constrain=constrain)

    def decode_step(self, params, token, caches, pos, active=None, rope_freqs=None,
                    constrain=None):
        return encdec.decode_step(
            params, self.cfg, token, caches, pos, active, cores=self.cores,
            rope_freqs=self.rope_freqs if rope_freqs is None else rope_freqs,
            constrain=constrain)

    def init_cache(self, batch: int, cache_len: int, device=None):
        enc_len = max(cache_len // self.cfg.enc_len_ratio, 1)
        return encdec.init_cache(self.cfg, batch, cache_len, enc_len,
                                 self.device if device is None else device)

    def reset_slots(self, caches, keep):
        return encdec.reset_slots(caches, keep)


def for_config(cfg: ArchConfig, device, *, cores: str = "kernel"):
    """The model of ``cfg``'s family (reference ``Model.for_config``)."""
    if cfg.family == "audio":
        return EncDecModel(cfg, device, cores=cores)
    return DecoderModel(cfg, device, cores=cores)
