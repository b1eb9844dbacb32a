"""internvl2-1b — VLM: InternViT frontend (STUB) + Qwen2-0.5B-style LM
backbone [arXiv:2404.16821]. input_specs supplies 256 patch embeddings."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm", source="arXiv:2404.16821",
    d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151655,
    head_dim=64, act="silu", rope_theta=1_000_000.0,
    period=(LayerSpec(mixer="attn", ffn="mlp"),), n_periods=24,
    n_prefix_tokens=256,
)
REDUCED = CONFIG.reduced()
