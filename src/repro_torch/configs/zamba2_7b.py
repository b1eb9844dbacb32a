"""zamba2-7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]. 81 layers = 13 x (5 mamba + 1 mamba-with-shared-attn)
+ 3 mamba remainder; the shared block params are reused at every
insertion (concat(h, emb0) at 2*d_model)."""
from repro_torch.configs.base import ArchConfig, LayerSpec

_M = LayerSpec(mixer="mamba", ffn="none")
_MS = LayerSpec(mixer="mamba", ffn="none", shared_attn=True)

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
    d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    act="silu",
    period=(_M,) * 5 + (_MS,), n_periods=13, remainder=(_M, _M, _M),
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=2,
    shared_attn_heads=32,
    supports_long_context=True,  # SSM state is O(1) in sequence length
)
REDUCED = CONFIG.reduced(period=(_M, _MS), remainder=(), ssm_groups=1)
