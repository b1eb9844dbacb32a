"""gemma3-4b — dense, 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt family]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

_LOCAL = LayerSpec(mixer="attn", ffn="mlp", window=1024)
_GLOBAL = LayerSpec(mixer="attn", ffn="mlp", window=None)

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense", source="hf:google/gemma-3-1b-pt",
    d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240, vocab=262144,
    head_dim=2560 // 8, qk_norm=True, act="gelu", rope_theta=1_000_000.0,
    # 34 layers = 5 x (5 local + 1 global) + 4 local remainder
    period=(_LOCAL,) * 5 + (_GLOBAL,), n_periods=5,
    remainder=(_LOCAL,) * 4,
    supports_long_context=True,
)
REDUCED = CONFIG.reduced(period=(_LOCAL, _GLOBAL), remainder=())
