#!/usr/bin/env python3
"""How far the port's ``flash_attention`` route drifts from exact attention
as causal rows grow, at Qwen3-0.6B's full width on one NVIDIA card, for one
checkout's ``src`` directory, so that two versions of the kernel can be
compared inside one run on one card:

    python3 benchmarks/torch/flash_long_rows.py [--src DIR] [--label NAME] [--seed 0]

Weights are drawn from ``--seed`` on the card, the prompt is one sequence
of uniform tokens.  For prompts of 512, 4,096 and 32,768 tokens, the
backbone runs three times: through the kernel (``attn_backend="kernel"``),
through the plain f32 route (``"chunked"``) and through the plain route
with its attention evaluated in f64 (everything else f32), the reference.
Printed for the kernel and the plain route: the residual stream's largest
difference from the reference after every third layer, and the logits'.
Then layer 0's attention on its own inputs at 32,768 tokens, the kernel's
and the plain f32 version's largest difference from an f64 evaluation in
each block of 4,096 rows.  ``--src`` (default: this checkout's ``src``)
picks the ``repro_torch`` that is imported.  Prints the card's name and
power limit, one JSON line per length and, last, one JSON line with all of
it.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
LENGTHS = (512, 4096, 32768)
PIECE = 2048  # logits rows at a time: 32,768 x 151,936 f32 is 20 GB


def attention_f64(q, k, v, *, causal, chunk=1024, q_offset=0):
    """``chunked_attention``'s arguments and loop, in f64: (B, L, H, hd)."""
    import torch

    B, Lq, H, hd = q.shape
    G = H // k.shape[2]
    k, v = (t.repeat_interleave(G, 2).double() for t in (k, v))
    qd = q.double() * hd ** -0.5
    rows = q_offset + torch.arange(Lq, device=q.device)
    m = torch.full((B, Lq, H), -1e300, dtype=torch.float64, device=q.device)
    den = torch.zeros((B, Lq, H), dtype=torch.float64, device=q.device)
    acc = torch.zeros((B, Lq, H, hd), dtype=torch.float64, device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("blhd,bchd->blhc", qd, kb)
        if causal:
            cols = c0 + torch.arange(kb.shape[1], device=q.device)
            s = torch.where((rows[:, None] >= cols[None, :])[None, :, None, :], s, -1e300)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("blhc,bchd->blhd", p, vb)
        m = m_new
    return (acc / den[..., None]).to(q.dtype)


def backbone(params, cfg, toks, route):
    """(final hidden state, the residual stream after each layer) on
    ``route``: "kernel", "chunked" or "f64"."""
    import torch

    from repro_torch.models import attention, transformer

    layers = []
    real_block, real_chunked = transformer._dense_block, attention.chunked_attention

    def block(*a, **kw):
        out = real_block(*a, **kw)
        layers.append(out[0].detach().clone())
        return out

    try:
        transformer._dense_block = block
        if route == "f64":
            attention.chunked_attention = attention_f64
        c = cfg.replace(attn_backend="kernel" if route == "kernel" else "chunked")
        T = toks.shape[1]
        with torch.no_grad():
            h, _ = transformer.backbone_apply(
                params, c, transformer.embed_tokens(params, c, toks),
                positions=torch.arange(T, device=toks.device).expand(1, T))
    finally:
        transformer._dense_block, attention.chunked_attention = real_block, real_chunked
    return h, layers


def logits_gap(params, cfg, a, b):
    from repro_torch.models.transformer import lm_logits

    return max(float((lm_logits(params, cfg, a[:, i:i + PIECE])
                      - lm_logits(params, cfg, b[:, i:i + PIECE])).abs().max())
               for i in range(0, a.shape[1], PIECE))


def layer0_by_rows(params, cfg, toks):
    """Layer 0's q, k, v at the prompt's length; the kernel's and the plain
    f32 version's largest difference from f64, by blocks of 4,096 rows."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention, transformer

    seen = []
    real = attention.flash_attention

    def spy(q, k, v, *rest):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone()))
        return real(q, k, v, *rest)

    c = cfg.replace(attn_backend="kernel")
    one = dict(params, layers=params["layers"][:1])
    T = toks.shape[1]
    try:
        attention.flash_attention = spy
        with torch.no_grad():
            x = transformer.embed_tokens(one, c, toks)
            positions = torch.arange(T, device=toks.device).expand(1, T)
            transformer.backbone_apply(one, c, x, positions=positions)
    finally:
        attention.flash_attention = real
    q, k, v = seen[0]  # (B, H, L, D)
    with torch.no_grad():
        got = {"kernel": ops.flash_attention(q, k, v, True).transpose(1, 2)}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        got["chunked"] = attention.chunked_attention(qt, kt, vt, causal=True)
        want = attention_f64(qt, kt, vt, causal=True).double()
        out = {"scale": float(want.abs().max())}
        for name, t in got.items():
            rows = (t.double() - want).abs().amax(dim=(0, 2, 3))
            out[name] = [float(rows[i:i + 4096].max()) for i in range(0, T, 4096)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_long_rows: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.transformer import lm_logits

    kernel.SOURCE.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = get_config("qwen3_0_6b")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = build_model(cfg).init(gen)
    toks = torch.randint(0, cfg.vocab, (1, max(LENGTHS)), generator=gen, device="cuda",
                         dtype=torch.int32)
    report = dict(label=args.label, device=smi, lengths={})
    for T in LENGTHS:
        runs = {r: backbone(params, cfg, toks[:, :T], r) for r in ("kernel", "chunked", "f64")}
        h_ref, layers_ref = runs.pop("f64")
        row = {}
        for name, (h, layers) in runs.items():
            row[name] = dict(
                layer_max_abs_err=[float((a - b).abs().max())
                                   for a, b in zip(layers[2::3], layers_ref[2::3])],
                logits_max_abs_err=logits_gap(params, cfg, h, h_ref))
        row["logit_scale"] = float(lm_logits(params, cfg, h_ref[:, -PIECE:]).abs().max())
        report["lengths"][T] = row
        print(json.dumps({"label": args.label, "length": T, **row}), flush=True)
        del runs, h_ref, layers_ref
        torch.cuda.empty_cache()
    report["layer0_rows_32768"] = layer0_by_rows(params, cfg, toks)
    print(json.dumps({"label": args.label, "layer0_rows": report["layer0_rows_32768"]}),
          flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
