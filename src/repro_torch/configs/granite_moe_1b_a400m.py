"""Granite-3.0-1B-A400M [moe]: 32 experts, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="granite_moe_1b_a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    n_experts=32,
    moe_top_k=8,
    moe_d_ff=512,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
        head_dim=16, n_experts=8, moe_top_k=2, moe_d_ff=96,
    )
