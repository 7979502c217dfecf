"""Qwen1.5-4B [dense]: QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1_5_4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
        head_dim=16,
    )
