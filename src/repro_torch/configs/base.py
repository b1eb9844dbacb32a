"""Architecture config schema (copy of ``repro.configs.base``).

The schema is the reference's, field for field, so a config means the
same model in both packages. The registry holds every arch of the
reference, each with its full config (``get_config``) and its reduced
one (``get_reduced``). nemotron-4-340b and llama4-maverick-400b-a17b are
not in ``PORTED_ARCH_IDS``: their full widths need more than one card,
and run sharded (``launch/mesh.py``, ``launch/dryrun.py``); one period of
llama4 is built at full width on one card.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
Mixer = Literal["attn", "mamba", "none"]
Ffn = Literal["mlp", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer = token mixer + channel mixer (ffn)."""

    mixer: Mixer = "attn"
    ffn: Ffn = "mlp"
    window: int | None = None  # sliding-window size; None = global attention
    shared_attn: bool = False  # Zamba2-style shared full block before mixer


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    source: str  # citation from the assignment pool
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    period: tuple[LayerSpec, ...]
    n_periods: int
    remainder: tuple[LayerSpec, ...] = ()
    head_dim: int | None = None  # default d_model // n_heads
    qk_norm: bool = False
    act: Literal["silu", "gelu", "sq_relu"] = "silu"
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    # Zamba2-style shared attention block (params shared across insertions)
    shared_attn_heads: int = 0
    # modality frontend stubs
    n_prefix_tokens: int = 0  # VLM: image patch embeddings prepended
    encoder_layers: int = 0  # audio enc-dec: encoder depth
    enc_len_ratio: int = 1  # encoder frames = seq_len // ratio
    # long_500k applicability (sub-quadratic decode path)
    supports_long_context: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_periods + len(self.remainder)

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        changes: dict = dict(
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512) or 256,
            vocab=min(self.vocab, 512),
            n_periods=1,
            period=self.period[: min(len(self.period), 2)],
            remainder=(),
            head_dim=None,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            shared_attn_heads=min(self.shared_attn_heads, 4),
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            encoder_layers=min(self.encoder_layers, 2),
            dtype="float32",
        )
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


# every arch of the reference, so a known-but-unported arch gets a clear
# NotImplementedError instead of "unknown arch"
ARCH_IDS: tuple[str, ...] = (
    "qwen3-0.6b",
    "gemma3-27b",
    "internvl2-1b",
    "zamba2-7b",
    "gemma3-4b",
    "llama4-maverick-400b-a17b",
    "nemotron-4-340b",
    "seamless-m4t-medium",
    "granite-moe-3b-a800m",
    "mamba2-2.7b",
)

# the archs one card builds whole at full width (the enc-dec one is
# trained, not served, as in the reference)
PORTED_ARCH_IDS: tuple[str, ...] = ("qwen3-0.6b", "mamba2-2.7b", "gemma3-4b",
                                    "gemma3-27b", "granite-moe-3b-a800m",
                                    "zamba2-7b", "internvl2-1b",
                                    "seamless-m4t-medium")
_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id in _MODULE_FOR:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULE_FOR[arch_id]}"
        )
    raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).REDUCED
