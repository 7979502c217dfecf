"""InternVL2-2B [vlm]: InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; hf]

The transformer backbone only, as in the JAX package: a prefill takes
precomputed patch embeddings (``batch["patches"]``, (B, n_patches,
d_model)), projected by ``patch_proj`` and put in front of the prompt; the
ViT frontend is a stub."""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2_2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    n_patches=256,
    source="arXiv:2404.16821; hf",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        head_dim=16, n_patches=8,
    )
