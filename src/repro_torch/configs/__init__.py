"""Configurations the port runs: the paper's PULSE workloads
(``pulse_paper``) and the LM architectures.

Each ``<arch>.py`` exports ``CONFIG`` (the published dims) and
``reduced()`` (the same family at tiny dims, for CPU tests); ``get_config``
maps ``--arch <id>`` to it.  ``ARCH_IDS`` holds the LM architectures, the
JAX package's ten in its order: the dense, vlm, ssm, hybrid, moe and encdec
families.  The input shapes of the launch tooling's cells are defined here
too (train_4k / prefill_32k / decode_32k / long_500k).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    nonparametric_norm: bool = False  # OLMo: RMSNorm without learned scale
    rope_theta: float = 10000.0
    attn_chunk: int = 1024  # kv-chunk of the plain blockwise attention
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_renormalize: bool = True
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    n_audio_frames: int = 1500
    # vlm
    n_patches: int = 0
    # numerics / execution
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    remat: str = "none"  # none | dots | full: what a layer keeps for its backward
    optimizer: str = "adamw"  # adamw | adafactor
    # "kernel": the flash_attention CUDA kernel (the JAX package's "pallas");
    # "chunked": plain blockwise attention in torch (its "xla")
    attn_backend: str = "kernel"
    # "kernel": the ssd_scan CUDA kernel (the JAX package's "pallas");
    # "chunked": the plain chunked SSD in torch (its "xla")
    ssm_backend: str = "kernel"
    ce_chunk: int = 512  # sequence chunk of the fused unembed + cross entropy
    decode_kv_f32: bool = True  # False: read the cache in its storage dtype
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * D
        if self.family in ("ssm",):
            d_in = self.ssm_expand * D
            per = D * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * D
            return self.n_layers * per + 2 * V * D
        if self.family == "hybrid":
            d_in = self.ssm_expand * D
            per = D * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * D
            return self.n_layers * per + attn + 3 * D * F + 2 * V * D
        mlp = 3 * D * F
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * self.moe_d_ff + D * self.n_experts
            mlp += self.n_shared_experts * 3 * D * self.moe_d_ff
        if self.family == "encdec":
            mlp = 2 * D * F
            return (
                self.n_enc_layers * (attn + mlp)
                + self.n_dec_layers * (2 * attn + mlp)
                + V * D
            )
        return self.n_layers * (attn + mlp) + 2 * V * D

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        attn = D * self.hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.hd * D
        mlp = (self.moe_top_k + self.n_shared_experts) * 3 * D * self.moe_d_ff
        mlp += D * self.n_experts  # router
        return self.n_layers * (attn + mlp) + 2 * self.vocab * D


ARCH_IDS = ["internvl2_2b", "granite_moe_1b_a400m", "kimi_k2_1t_a32b", "whisper_large_v3",
            "zamba2_7b", "qwen3_0_6b", "qwen1_5_4b", "qwen3_4b", "olmo_1b", "mamba2_780m"]


# ---------------------------- input shapes ----------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# cells skipped, with the reason
SKIPPED_CELLS = {("whisper_large_v3", "long_500k"):
                 "enc-dec decoder: 30s audio source; no meaningful 500k self-attn KV"}


def all_cells(include_skipped: bool = False):
    """Every (arch, shape) cell of the launch tooling, the skips left out
    unless ``include_skipped``."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if include_skipped or (a, s) not in SKIPPED_CELLS]


def _module(arch_id: str):
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()
