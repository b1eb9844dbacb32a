"""qwen3-0.6b — dense, GQA, qk-norm [hf:Qwen/Qwen3-8B family].

Copy of ``repro.configs.qwen3_0_6b``. ``head_dim=64`` is the repo's
value (the published Qwen3-0.6B uses 128); the port serves the repo's
config, and its attention kernel takes both head sizes.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense", source="hf:Qwen/Qwen3-8B",
    d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072, vocab=151936,
    head_dim=64, qk_norm=True, act="silu", rope_theta=1_000_000.0,
    period=(LayerSpec(mixer="attn", ffn="mlp"),), n_periods=28,
)
REDUCED = CONFIG.reduced()
