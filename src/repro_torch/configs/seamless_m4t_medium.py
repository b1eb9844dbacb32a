"""seamless-m4t-medium — encoder-decoder, multimodal audio->text
[arXiv:2308.11596]. Audio frontend (mel + conv) is a STUB; input_specs
supplies frame embeddings at seq_len//4. 12 encoder + 12 decoder layers."""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio", source="arXiv:2308.11596",
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    act="gelu",
    period=(LayerSpec(mixer="attn", ffn="mlp"),), n_periods=12,
    encoder_layers=12, enc_len_ratio=4,
)
REDUCED = CONFIG.reduced()
