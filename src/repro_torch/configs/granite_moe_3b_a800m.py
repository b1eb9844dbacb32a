"""granite-moe-3b-a800m — MoE 40 experts top-8, per-expert d_ff=512
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
    head_dim=64, act="silu", rope_theta=10_000.0,
    period=(LayerSpec(mixer="attn", ffn="moe"),), n_periods=32,
    n_experts=40, top_k=8,
)
REDUCED = CONFIG.reduced()
