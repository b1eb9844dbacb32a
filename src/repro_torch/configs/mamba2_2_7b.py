"""mamba2-2.7b — attention-free SSM via SSD (state-space duality)
[arXiv:2405.21060]. 64 Mamba2 layers, d_state=128, headdim=64.

Copy of ``repro.configs.mamba2_2_7b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", source="arXiv:2405.21060",
    d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
    act="silu",
    period=(LayerSpec(mixer="mamba", ffn="none"),), n_periods=64,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    supports_long_context=True,
)
REDUCED = CONFIG.reduced()
