"""gemma3-27b — dense, 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt family]."""
from repro_torch.configs.base import ArchConfig, LayerSpec

_LOCAL = LayerSpec(mixer="attn", ffn="mlp", window=1024)
_GLOBAL = LayerSpec(mixer="attn", ffn="mlp", window=None)

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense", source="hf:google/gemma-3-1b-pt",
    d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144,
    head_dim=5376 // 32, qk_norm=True, act="gelu", rope_theta=1_000_000.0,
    # 62 layers = 10 x (5 local + 1 global) + 2 local remainder
    period=(_LOCAL,) * 5 + (_GLOBAL,), n_periods=10,
    remainder=(_LOCAL, _LOCAL),
    supports_long_context=True,  # local layers cache only `window`
)
REDUCED = CONFIG.reduced(period=(_LOCAL, _GLOBAL), remainder=())
