"""Mamba2-780M [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2_780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # attention-free; unused
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2405.21060; unverified",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    )
