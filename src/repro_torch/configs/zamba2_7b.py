"""Zamba2-7B [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

81 Mamba2 layers with ONE shared (weight-tied) attention+MLP block applied
after every 6 mamba blocks (13 applications; a tail of 3 mamba layers),
simplified from Zamba2's two alternating shared blocks as in the JAX
package."""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2_7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    source="arXiv:2411.15242; unverified",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        head_dim=16, ssm_state=16, ssm_head_dim=16, hybrid_attn_every=2,
    )
