"""Qwen3-4B [dense]: qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3_4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
        head_dim=16,
    )
