"""K2 — causal flash attention (``csrc/flash_attn.cu``).

Replaces ``repro/kernels/flash_attn.py::flash_attention`` and the GQA head
repeat of ``repro/kernels/ops.py::flash_attention``.  Layout is the
reference's: q ``(B, S, H, hd)``, k and v ``(B, S, Hkv, hd)``.  bf16 runs on
``wgmma`` tensor cores with TMA-fed K/V tiles (P rounded to bf16 before
P.V, the softmax in f32); it is bound by bytes at the main path's prefill
shape and by operations from S of about 750 on, and gives the same bits run
to run and at every batch position.  f32 keeps the plain-FMA kernel, whose
arithmetic meets the reference's 2e-5 (see the source).  Head dims 64, 80
(zamba2's shared attention) and 128 run on the card; at 80 the bf16 kernel
pads its tiles to 128 columns with TMA's zero fill.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.roofline import counter

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain version of K2, in the reference's order: q scaled by hd**-0.5
    in f32 before the dot, keys after the query masked to -1e30, f32
    softmax, output ``acc / max(l, 1e-30)`` in q's dtype, laid out
    contiguous as the kernel writes it."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qf = q.float() * hd ** -0.5
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, vf)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention; returns ``(B, S, H, hd)`` in q's dtype."""
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} q heads over {Hkv} kv heads")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; takes one of {tuple(_DTYPE_CODE)}")
    with counter.charge("flash_attention", lambda: counter.flash_work(
            B, S, H, Hkv, hd, q.element_size())):
        where = ops.route(q, k, v)
        if where == "cpu":
            return flash_attention_plain(q, k, v)
        if where == "meta":
            return torch.empty_like(q)
        return _launch(q, k, v)


def _launch(q, k, v):
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if q.dtype == torch.bfloat16 and (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("flash_attention: bf16 q, k and v must start on a "
                         "16-byte boundary (TMA)")
    out = torch.empty_like(q)
    ops.launch("flash_attention", "ishmem_flash_attention",
               q.get_device(), *ptrs, out.data_ptr(), B, S, H, k.shape[2], hd,
               _DTYPE_CODE[q.dtype], hd ** -0.5)
    return out
