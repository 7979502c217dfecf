"""Whisper-large-v3 [audio]: enc-dec, conv frontend (stub).
[arXiv:2212.04356; unverified]

Backbone only, as in the JAX package: a prefill takes precomputed mel/conv
frame embeddings (``batch["frames"]``, (B, 1500, d_model)); the conv
frontend is a stub.  32 encoder + 32 decoder layers, LayerNorm + GELU MLP +
sinusoidal positions (no RoPE), QKV bias (``models/whisper.py``)."""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper_large_v3",
    family="encdec",
    n_layers=32,
    n_enc_layers=32,
    n_dec_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    qkv_bias=True,
    n_audio_frames=1500,
    source="arXiv:2212.04356; unverified",
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, head_dim=16, n_audio_frames=16,
    )
