"""Decode attention over the gathered block payload or a dense cache
(``csrc/decode_attn.cu``).

It replaces no ``pallas_call``: the reference decodes in plain jnp
(``repro/models/attention.py::decode_attn`` over the one-hot-written
dense cache).  The port added it so the paged decode step attends where
K3 put the cache (``serve/paged_attn.py``): no dense leaf rebuilt, no
whole-cache rewrite, no f32 copy of K and V, no stacked new cache.

One query token a row attends over positions ``[0, n_b)``, ``n_b =
min(pos_b + 1, W)``.  K and V are a dense cache ``(B, W, nkv, hd)`` or a
view ``(B, nb, T, nkv, hd)`` of the gathered block payload (``W = nb *
T``), with any strides.  Given ``k_new`` / ``v_new`` the row's new column
is first stored in place at ``pos_b`` (nothing where ``pos_b >= W``).  q is
widened to f32 and scaled by ``hd ** -0.5``, scores, softmax and both sums
are f32, the output is in q's dtype.  On the card the kernel takes bf16 and
splits each (row, KV head) over fixed chunks of :data:`CHUNK` positions,
merged in chunk order, so a row's output depends on its own inputs only
(bitwise run to run, across batch positions and bank sizes, and between
the dense and the payload view).  Bound by bytes: the live K/V rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.roofline import counter

CHUNK = 64                  # positions a CTA attends over (csrc kChunk)
MAX_HEAD_DIM = 256
MAX_GROUP = 16
MAX_GRID = 65535            # B and nkv map to gridDim.z and gridDim.y
MAX_WIDTH = 12288 * CHUNK   # the merge keeps a weight a chunk in 48 KB


def _blocks(kv: torch.Tensor) -> torch.Tensor:
    """``(B, nb, T, nkv, hd)``: a dense ``(B, W, nkv, hd)`` cache as one
    block of W positions, a payload view as it is."""
    return kv.unsqueeze(1) if kv.dim() == 4 else kv


def decode_attention_plain(q, k, v, pos, k_new=None, v_new=None):
    """Plain version: each row's new column stored in place at ``pos_b``
    (nothing past the cache, a dense cache's overrun rule), the positions
    gathered in order, and ``models/attention.py::full_attn`` under the
    validity mask ``position <= pos``, which on a dense cache is the
    decode step's own attention, bitwise."""
    k5, v5 = _blocks(k), _blocks(v)
    T = k5.shape[2]
    W = k5.shape[1] * T
    if k_new is not None:
        rows = torch.nonzero(pos < W).flatten()
        p = pos[rows]
        k5[rows, p // T, p % T] = k_new[rows, 0].to(k5.dtype)
        v5[rows, p // T, p % T] = v_new[rows, 0].to(v5.dtype)
    valid = torch.arange(W, device=pos.device)[None, :] <= pos[:, None]
    return attention.full_attn(q, k5.flatten(1, 2), v5.flatten(1, 2),
                               mask=valid)


def decode_attention(q, k, v, pos, k_new=None, v_new=None):
    """``(B, 1, nq, hd)`` attention of one token a row over a dense or
    payload-view cache (module docstring), the new column stored first
    where ``k_new`` / ``v_new`` are given.  CPU tensors take the plain
    version, ``meta`` ones an empty output, CUDA ones the kernel (bf16
    only: it raises on other dtypes)."""
    k5, v5 = _blocks(k), _blocks(v)
    B, one, nq, hd = q.shape
    if k5.dim() != 5 or k5.shape != v5.shape or one != 1 or \
            k5.shape[0] != B or k5.shape[4] != hd or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, pos "
                         f"{tuple(pos.shape)}")
    nb, T, nkv = k5.shape[1:4]
    if nkv == 0 or nq % nkv or nq // nkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {nq} q heads over {nkv} kv "
                         f"heads (at most {MAX_GROUP} a kv head)")
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {hd} is not a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    new = () if k_new is None else (k_new, v_new)
    if (k_new is None) != (v_new is None) or any(
            tuple(t.shape) != (B, 1, nkv, hd) for t in new):
        raise ValueError("decode_attention: k_new and v_new go together, "
                         f"each ({B}, 1, {nkv}, {hd})")
    with counter.charge("decode_attention", lambda: counter.decode_attn_work(
            B, nb * T, nq, nkv, hd, k.element_size(), stores=bool(new))):
        where = ops.route(q, k, v, pos, *new)
        if where == "cpu":
            return decode_attention_plain(q, k, v, pos, k_new, v_new)
        if where == "meta":
            return torch.empty_like(q)
        return _launch(q, k5, v5, pos, new)


def _launch(q, k, v, pos, new):
    B, nb, T, nkv, hd = k.shape
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16 or any(
            t.dtype != torch.bfloat16 for t in new):
        raise TypeError(f"decode_attention: the kernel takes bf16; got q "
                        f"{q.dtype}, k {k.dtype}, v {v.dtype}")
    if pos.dtype.is_floating_point or pos.dtype.is_complex:
        raise TypeError(f"decode_attention: pos must be integers, not "
                        f"{pos.dtype}")
    if B > MAX_GRID or nkv > MAX_GRID or nb * T > MAX_WIDTH:
        raise ValueError(f"decode_attention: {B} rows x {nkv} kv heads x "
                         f"{nb * T} positions exceed the grid ({MAX_GRID}) "
                         f"or the width ({MAX_WIDTH})")
    if k.stride() != v.stride() or k.stride(4) != 1 or any(
            s % 8 for s in k.stride()[:4]):
        raise ValueError(f"decode_attention: k and v need one stride set, "
                         f"a contiguous head dim and other strides in "
                         f"16-byte units; got {k.stride()} / {v.stride()}")
    new = tuple(t.contiguous() for t in new)
    if any(t.data_ptr() % 16 for t in (k, v, *new)):
        raise ValueError("decode_attention: k, v, k_new and v_new must start "
                         "on a 16-byte boundary")
    q, pos = q.contiguous(), pos.to(torch.int64).contiguous()
    g = q.shape[2] // nkv
    chunks = -(-nb * T // CHUNK)
    acc = torch.empty((B, nkv, chunks, g, hd), dtype=torch.float32,
                      device=q.device)
    ml = torch.empty((B, nkv, chunks, g, 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    k_new, v_new = new or (None, None)
    ops.launch("decode_attention", "ishmem_decode_attention", q.get_device(),
               q.data_ptr(), k.data_ptr(), v.data_ptr(),
               None if k_new is None else k_new.data_ptr(),
               None if v_new is None else v_new.data_ptr(), pos.data_ptr(),
               acc.data_ptr(), ml.data_ptr(), out.data_ptr(), B, nb, T, nkv,
               g, hd, *k.stride()[:4], hd ** -0.5)
    return out
