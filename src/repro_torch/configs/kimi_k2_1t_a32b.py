"""Kimi-K2 [moe]: trillion-param MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2; unverified (paper-table)]

bf16 params, Adafactor (factored second moment) and full remat at full
size (about 1 T parameters, 2 TB in bf16: no single card holds it, so the
port runs it only reduced)."""

import torch

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="kimi_k2_1t_a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    n_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
    optimizer="adafactor",
    remat="full",
    source="arXiv:2501.kimi2; unverified",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
        head_dim=16, n_experts=8, moe_top_k=2, moe_d_ff=64, n_shared_experts=1,
        param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
        optimizer="adamw",
    )
