"""OLMo-1B [dense]: non-parametric LN.  [arXiv:2402.00838; hf]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="olmo_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    head_dim=128,
    nonparametric_norm=True,
    source="arXiv:2402.00838; hf",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        head_dim=16,
    )
