"""nemotron-4-340b — dense, GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense", source="arXiv:2402.16819",
    d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728, vocab=256000,
    head_dim=192, act="sq_relu", rope_theta=10_000.0,
    period=(LayerSpec(mixer="attn", ffn="mlp"),), n_periods=96,
)
REDUCED = CONFIG.reduced()
