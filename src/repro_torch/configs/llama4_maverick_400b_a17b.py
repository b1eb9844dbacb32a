"""llama4-maverick-400b-a17b — MoE 128 experts top-1 + shared expert,
dense/MoE alternating, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E
family]. 48 layers = 24 x (dense, moe)."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    head_dim=128, act="silu", rope_theta=500_000.0,
    period=(LayerSpec(mixer="attn", ffn="mlp"),
            LayerSpec(mixer="attn", ffn="moe")),
    n_periods=24,
    n_experts=128, top_k=1, shared_expert=True,
)
REDUCED = CONFIG.reduced()
