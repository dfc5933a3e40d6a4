"""Device-initiated kernels: the paged gather, fused paged attention and
ring attention.

Counterpart of ``repro/kernels/ishmem_device.py``:

- **K3** :func:`paged_gather` (``csrc/ishmem_device.cu``) replaces
  ``_paged_gather_pallas`` and its wrapper, which the reference's
  ``PagedDecodeView.assemble`` did not call (it gathered with
  ``data[table]``); the port's ``assemble`` does.  The reference's
  probe-and-fallback has no counterpart.  Bound by bytes.
- **K11** :func:`fused_paged_attn`: per-block device ``signal_wait_until``
  gates and a work-group get of the pool row, then, for a bf16 pool and q,
  one kernel (:func:`paged_flash_attention`, ``csrc/flash_attn.cu``) that
  spins on the signal words and attends over one layer's K and V read
  through the slot table: K2's bf16 body with a paged K/V source, bitwise
  equal to ``assemble`` followed by K2.  Other dtypes on the card take K3
  and K2's f32 kernel.  Bound by bytes: q, out and one layer's K/V.
- **K10** :func:`flash_partial` (``csrc/flash_partial.cu``) replaces the
  Pallas ``flash_partial``: one ring step's unnormalised causal partial at
  absolute offsets, on TF32 tensor cores in split precision (three TF32
  products per matrix product over hi/lo parts that
  :func:`flash_partial_split` writes).  :func:`merge_partials` and
  :func:`ring_attention` are plain torch over its outputs.  Bound by
  operations.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import flash_attn, ops
from repro_torch.roofline import counter

MAX_ROWS = 65535            # table entries map to gridDim.y
# K10's kernels are instantiated for these head dims only (32: the
# launcher's ring demo; 80: zamba2's attention width, tiles padded to 96)
PARTIAL_HEAD_DIMS = (32, 64, 80, 128)


def paged_gather_plain(data: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``out[b, j] = data[table[b, j]]``, where an
    entry equal to ``data.shape[0]`` reads a row of zeros."""
    out = data.new_zeros((*table.shape, data.shape[1]))
    mapped = table < data.shape[0]
    out[mapped] = data[table[mapped].long()]
    return out


def paged_gather(data: torch.Tensor, table) -> torch.Tensor:
    """Gather block payload rows through a block table.

    ``data``: ``(num_rows, block_words)``, any dtype; ``table``:
    ``(num_slots, nb)`` int32 with entries in ``[0, num_rows]``, where
    ``num_rows`` marks an unmapped slot that reads zeros.  Returns
    ``(num_slots, nb, block_words)``, bitwise what ``data[table]`` gives
    over ``data`` with a zero row appended.

    ``data`` alone decides the route: on the CPU the plain version (the
    table must lie on the CPU too), on ``meta`` an empty output, on the
    card the kernel.  The table may
    be a numpy array or a CPU tensor (a host table, as the serving path
    passes it): its range is checked on the host and it reaches the card in
    one non-blocking copy from pinned memory, so the call never waits for
    the device.  A table already on the card is checked with one
    ``torch.aminmax`` read, which waits for the device once."""
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("paged_gather: data must be a contiguous 2-D array")
    if isinstance(table, np.ndarray):
        table = torch.from_numpy(np.ascontiguousarray(table))
    if table.dim() != 2 or table.dtype != torch.int32:
        raise TypeError("paged_gather: table must be a 2-D int32 array")
    R = data.shape[0]
    host = table.device.type == "cpu"
    where = ops.route(data)
    if where == "cpu" or not host:
        ops.route(data, table)     # both on the CPU or meta, or on one card
    with counter.charge("paged_gather", lambda: counter.gather_work(
            table.numel(), data.shape[1] * data.element_size())):
        if table.numel() and not table.is_meta:
            lo, hi = torch.stack(torch.aminmax(table)).tolist()
            if lo < 0 or hi > R:
                raise IndexError(f"paged_gather: table entries outside "
                                 f"[0, {R}]")
        if where == "cpu":
            return paged_gather_plain(data, table)
        if where == "meta":
            return data.new_empty((*table.shape, data.shape[1]))
        return _gather_launch(data, table, host)


def _gather_launch(data, table, host):
    R = data.shape[0]
    if table.numel() > MAX_ROWS:
        raise ValueError(f"paged_gather: {table.numel()} entries exceed "
                         f"{MAX_ROWS}")
    table = table.contiguous()
    if host:
        table = table.pin_memory().to(data.device, non_blocking=True)
    out = torch.empty((*table.shape, data.shape[1]), dtype=data.dtype,
                      device=data.device)
    ops.launch("paged_gather", "ishmem_paged_gather", data.get_device(),
               out.data_ptr(), data.data_ptr(), table.data_ptr(),
               table.numel(), data.shape[1] * data.element_size(), R)
    return out


# ---------------------------------------------------------------------------
# K11: fused paged attention
# ---------------------------------------------------------------------------


def paged_layer_plain(data: torch.Tensor, table: torch.Tensor, off: int,
                      leaf, layer: int, block_tokens: int) -> torch.Tensor:
    """One layer of one paged leaf, ``(num_slots, width, nkv, hd)``: the
    leaf at word ``off`` of each block payload holds ``(reps, T, nkv, hd)``,
    so layer L's tokens are ``T * nkv * hd`` words from ``off + L * T * nkv
    * hd``.  Only those words of each mapped block are read; an unmapped
    entry (``== data.shape[0]``) reads zeros, and keys past ``leaf.width``
    are cut.  Bitwise ``KVLayout.gathered_leaf`` of K3's gather at that
    layer."""
    n = block_tokens * leaf.nkv * leaf.hd
    start = off + layer * n
    idx = table.long()
    mapped = idx < data.shape[0]
    rows = data.new_zeros((*table.shape, n))
    rows[mapped] = data[idx[mapped], start:start + n]
    return rows.reshape(table.shape[0], table.shape[1] * block_tokens,
                        leaf.nkv, leaf.hd)[:, :leaf.width]


def fused_paged_attn_plain(data: torch.Tensor, table, q: torch.Tensor, *,
                           k_off: int, v_off: int, leaf, layer: int,
                           block_tokens: int, dtype=None) -> torch.Tensor:
    """Plain version of K11: one layer's K and V gathered by table
    arithmetic (:func:`paged_layer_plain`; the payloads of the other layers
    and leaves are never read), cast to ``dtype`` if given, then K2's plain
    version."""
    table = torch.as_tensor(table, device=data.device)
    k, v = (paged_layer_plain(data, table, off, leaf, layer, block_tokens)
            for off in (k_off, v_off))
    if dtype is not None:
        k, v = k.to(dtype), v.to(dtype)
    return flash_attn.flash_attention_plain(q, k.contiguous(),
                                            v.contiguous())


def paged_flash_attention(data: torch.Tensor, table, q: torch.Tensor, *,
                          k_off: int, v_off: int, leaf, layer: int,
                          block_tokens: int, signals=()) -> torch.Tensor:
    """K11's kernel: causal GQA attention of ``q`` ``(num_slots, width, nq,
    hd)`` against layer ``layer`` of the K and V leaves at word offsets
    ``k_off`` and ``v_off`` of the block payloads in ``data`` ``(num_blocks,
    block_words)``, read through ``table`` ``(num_slots, nb)`` (entries in
    ``[0, num_blocks]``, ``num_blocks`` unmapped).  ``leaf`` gives ``reps``,
    ``width``, ``nkv`` and ``hd`` (a ``PagedLeaf``).  Returns ``(num_slots,
    width, nq, hd)``, bitwise K2 on the gathered layer.

    On the CPU: the plain version.  On the card, bf16 only: one launch.
    The table (numpy or a CPU tensor) is range-checked on the host and
    reaches the card with the ``signals`` (pairs of a one-word int32 card
    tensor and the value it must reach) in one non-blocking copy from
    pinned memory; the kernel spins on each word before it reads a block.
    TMA needs q, each leaf's first block and the block stride on the
    16-byte grid, and T a multiple of 8 dividing 128: otherwise it
    raises."""
    T = block_tokens
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("paged attention: data must be a contiguous 2-D "
                         "array")
    if isinstance(table, np.ndarray):
        table = torch.from_numpy(np.ascontiguousarray(table))
    if table.dim() != 2 or table.dtype != torch.int32 or table.is_cuda:
        raise TypeError("paged attention: the table must be a 2-D int32 "
                        "host array")
    B, W, nq, hd = q.shape
    R, words = data.shape
    if (table.shape[0] != B or W != leaf.width or hd != leaf.hd
            or nq % leaf.nkv or table.shape[1] * T < W):
        raise ValueError(f"paged attention: q {tuple(q.shape)} against a "
                         f"({table.shape[0]}, {table.shape[1]}) table of "
                         f"{T}-token blocks, leaf width {leaf.width}, "
                         f"{leaf.nkv} kv heads of {leaf.hd}")
    if max(k_off, v_off) + leaf.reps * T * leaf.nkv * hd > words:
        raise ValueError(f"paged attention: a leaf at {k_off} or {v_off} "
                         f"overruns the {words}-word payload")
    with counter.charge("fused_paged_attn", lambda: counter.paged_attn_work(
            B, W, nq, leaf.nkv, hd, q.element_size())):
        if table.numel():
            lo, hi = torch.stack(torch.aminmax(table)).tolist()
            if lo < 0 or hi > R:
                raise IndexError(f"paged attention: table entries outside "
                                 f"[0, {R}]")
        where = ops.route(data, q)
        if where == "cpu":
            return fused_paged_attn_plain(data, table, q, k_off=k_off,
                                          v_off=v_off, leaf=leaf,
                                          layer=layer, block_tokens=T)
        if where == "meta":
            return torch.empty_like(q)
        return _paged_launch(data, table, q, k_off, v_off, leaf, layer, T,
                             signals)


def _paged_launch(data, table, q, k_off, v_off, leaf, layer, T, signals):
    B, W, nq, hd = q.shape
    R, words = data.shape
    if not data.dtype == q.dtype == torch.bfloat16:
        raise TypeError(f"paged attention: the kernel takes a bf16 pool and "
                        f"q, got {data.dtype} and {q.dtype}")
    if hd not in flash_attn.HEAD_DIMS:
        raise ValueError(f"paged attention: head_dim {hd} not in "
                         f"{flash_attn.HEAD_DIMS}")
    if T % 8 or 128 % T:
        raise ValueError(f"paged attention: {T}-token blocks; the kernel "
                         f"takes a multiple of 8 that divides 128")
    if not q.is_contiguous():
        raise ValueError("paged attention: q must be contiguous")
    base, esize = data.data_ptr(), data.element_size()
    kp, vp = base + k_off * esize, base + v_off * esize
    if (q.data_ptr() | kp | vp | words * esize) % 16:
        raise ValueError("paged attention: q, the K and V leaves' first "
                         "block and the block stride must lie on the "
                         "16-byte grid (TMA)")
    words_of = []
    for word, value in signals:
        if word.numel() != 1 or word.dtype != torch.int32:
            raise TypeError("paged attention: a signal is one int32 word")
        ops.route(data, word)              # on the pool's card
        words_of += [word.data_ptr(), int(value)]
    meta = np.empty(2 * len(words_of) + table.numel(), np.int32)
    meta[:2 * len(words_of)].view(np.int64)[:] = words_of
    meta[2 * len(words_of):] = table.reshape(-1).numpy()
    meta = torch.from_numpy(meta).pin_memory().to(data.device,
                                                  non_blocking=True)
    out = torch.empty_like(q)
    ops.launch("fused_paged_attn", "ishmem_fused_paged_attn",
               data.get_device(), q.data_ptr(), kp, vp, out.data_ptr(),
               meta.data_ptr(), len(signals), B, W, nq, leaf.nkv, hd,
               leaf.reps * T, R, words * esize, table.shape[1], T, layer,
               hd ** -0.5)
    return out


def fused_paged_attn(wg, heap, view, q: torch.Tensor, *, unit_idx=None,
                     layer: int = 0, waits=(), dtype=None):
    """Device-initiated fused gather + attention over the paged KV pool.

    ``wg`` is the calling work-group (``core.device.work_group``), ``view``
    a ``serve.paged_attn.PagedDecodeView``.  Each ``(sig_ptr, expected)`` of
    ``waits`` is a device ``signal_wait_until(sig >= expected)`` on the
    view's PE, all consumed BEFORE any block byte is read; a wait that no
    pending traffic can satisfy raises.  ``q``: ``(num_slots, W, nq, hd)``
    against the assembled width.  Returns ``(heap, out)``, ``out`` bitwise
    equal to ``assemble`` of the same leaves followed by K2.

    Routes, by where the pool lies and its dtype: on the CPU the plain
    version; on the card, a bf16 pool and q with ``dtype`` None or bf16
    launch K11 once (:func:`paged_flash_attention`; it spins on the same
    signal words itself); any other dtype on the card gathers every table
    block with K3 and runs K2's f32 kernel on the extracted layer."""
    from repro_torch.core import device as device_mod

    for sig_ptr, expected in waits:
        heap, _, ok = device_mod.signal_wait_until(
            wg, heap, sig_ptr, view.pe, "ge", expected)
        if not ok:
            raise RuntimeError(
                "fused_paged_attn: signal can never satisfy its wait — "
                "reading a block here would observe pre-signal bytes")
    lay = view.pool.layout
    if not lay.paged:
        raise ValueError("fused_paged_attn requires a paged layout")
    if unit_idx is None:
        unit_idx = lay.paged[0].unit_idx
    k_leaf, v_leaf = (next(p for p in lay.paged if p.path == (unit_idx, key))
                      for key in ("k", "v"))
    if (k_leaf.reps, k_leaf.width, k_leaf.nkv, k_leaf.hd) != \
            (v_leaf.reps, v_leaf.width, v_leaf.nkv, v_leaf.hd):
        raise ValueError("fused_paged_attn: K and V leaves of unit "
                         f"{unit_idx} differ in shape")
    # collaborative local load of the pool row (device_get telemetry at the
    # group's width): a view, no copy
    data = device_mod.get_view(wg, heap, view.pool.data, view.pe).reshape(
        view.pool.num_blocks, lay.block_words)
    k_off, v_off = (lay.leaf_offsets[x.path] for x in (k_leaf, v_leaf))
    with counter.charge("fused_paged_attn", lambda: counter.paged_attn_work(
            q.shape[0], q.shape[1], q.shape[2], k_leaf.nkv, k_leaf.hd,
            q.element_size())):
        route = fused_route(data, q, dtype)
        if route == "meta":
            return heap, torch.empty_like(q)
        if route == "composition":
            pay = paged_gather(data, view.table())     # a host table: no sync
            k = lay.gathered_leaf(pay, k_leaf)[layer]
            v = lay.gathered_leaf(pay, v_leaf)[layer]
            if dtype is not None:
                k, v = k.to(dtype), v.to(dtype)
            return heap, flash_attn.flash_attention(q, k.contiguous(),
                                                    v.contiguous())
        if route == "plain":
            return heap, fused_paged_attn_plain(
                data, view.table(), q, k_off=k_off, v_off=v_off,
                leaf=k_leaf, layer=layer, block_tokens=lay.block_tokens,
                dtype=dtype)
        signals = [(heap.read(sig_ptr, view.pe), expected)
                   for sig_ptr, expected in waits]
        return heap, paged_flash_attention(
            data, view.table(), q, k_off=k_off, v_off=v_off, leaf=k_leaf,
            layer=layer, block_tokens=lay.block_tokens, signals=signals)


def fused_route(data, q, dtype=None) -> str:
    """The route :func:`fused_paged_attn` takes: ``"plain"`` for a pool
    row on the CPU; ``"meta"`` for one on ``meta`` (an empty output);
    ``"kernel"`` (K11, one launch) for a bf16 pool and q on the card with
    ``dtype`` None or bf16; ``"composition"`` (K3 over every table block,
    then K2 on the extracted layer) for any other dtype on the card."""
    if not data.is_cuda:
        return "meta" if data.is_meta else "plain"
    bf16 = torch.bfloat16
    if data.dtype == q.dtype == bf16 and dtype in (None, bf16):
        return "kernel"
    return "composition"


# ---------------------------------------------------------------------------
# K10: one ring step's partial attention, and the ring built from it
# ---------------------------------------------------------------------------


def flash_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_off: int, k_off: int):
    """Plain version of K10, in the reference's order: q scaled by
    hd**-0.5 in f32 before the dot, keys after the query's absolute
    position masked to -1e30, then ``m = max``, ``p = exp(s - m)``,
    ``l = sum p``, ``acc = p @ v``, all in f32.  A row that sees no key gets
    ``m = -1e30``, ``l = Skv``, ``acc = sum v``, as in the reference."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qf = q.float() * hd ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    qpos = q_off + torch.arange(Sq, device=q.device)
    kpos = k_off + torch.arange(Skv, device=q.device)
    visible = kpos[None, :] <= qpos[:, None]
    s = torch.where(visible, s, torch.full_like(s, flash_attn.NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return (acc.permute(0, 2, 1, 3).contiguous(),
            m.permute(0, 2, 1).contiguous(), l.permute(0, 2, 1).contiguous())


# Within every group of 8 keys, V^T's position i holds key KEY_ORDER[i]:
# the order in which the kernel's score accumulator hands P to P.V
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` does: the low 13 bits of the magnitude cleared
    after adding half of their weight."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> torch.Tensor:
    hi = tf32_round(x)
    return torch.stack([hi, tf32_round(x - hi)])


def _check_partial(q, k, v) -> str:
    """Raise on inputs K10 does not take; else the route (``ops.route``)."""
    B, Sq, H, hd = q.shape
    if (k.shape != v.shape or k.dim() != 4 or k.shape[0] != B
            or k.shape[2:] != (H, hd) or k.shape[1] < 1):
        raise ValueError(f"flash_partial: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    codes = flash_attn._DTYPE_CODE
    if not q.dtype == k.dtype == v.dtype or q.dtype not in codes:
        raise TypeError(f"flash_partial: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; takes one of {tuple(codes)}")
    where = ops.route(q, k, v)
    if where != "cuda":
        return where
    if hd not in PARTIAL_HEAD_DIMS:
        raise ValueError(f"flash_partial: head_dim {hd} not in "
                         f"{PARTIAL_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_partial: q, k and v must be contiguous")
    return where


def flash_partial_split_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor):
    """Plain version of K10's split pass: ``(qs, ks, vt)``, f32 hi/lo
    planes (hi = TF32 rounding, lo = the rest rounded again).  ``qs``:
    ``(2, B, Sq, H, hd)`` of ``q * hd**-0.5``; ``ks``: ``(2, B, Skv, H,
    hd)`` of k; ``vt``: ``(2, B, H, hd, Skv8)`` of v transposed, ``Skv8``
    = Skv rounded up to 8, zero keys past Skv, and the keys of each group
    of 8 in :data:`KEY_ORDER`."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    Skv8 = -(-Skv // 8) * 8
    vf = v.float().new_zeros((B, Skv8, H, hd))
    vf[:, :Skv] = v.float()
    perm = torch.tensor(KEY_ORDER, device=v.device)
    order = (torch.arange(0, Skv8, 8, device=v.device)[:, None]
             + perm[None, :]).reshape(-1)
    vt = vf[:, order].permute(0, 2, 3, 1)
    return _split(q.float() * hd ** -0.5), _split(k.float()), _split(vt)


def flash_partial_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K10's split pass (``split_rows`` and ``split_vt``): the hi/lo planes
    that :func:`flash_partial_split_plain` describes, in one call."""
    where = _check_partial(q, k, v)
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    with counter.charge("flash_partial_split", lambda: counter.split_work(
            B, Sq, Skv, H, hd, q.element_size())):
        if where == "cpu":
            return flash_partial_split_plain(q, k, v)
        f32 = dict(dtype=torch.float32, device=q.device)
        qs = torch.empty((2, B, Sq, H, hd), **f32)
        ks = torch.empty((2, B, Skv, H, hd), **f32)
        vt = torch.empty((2, B, H, hd, -(-Skv // 8) * 8), **f32)
        if where == "cuda":
            ops.launch("flash_partial_split", "ishmem_flash_partial_split",
                       q.get_device(), q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), qs.data_ptr(), ks.data_ptr(),
                       vt.data_ptr(), B, Sq, Skv, H, hd,
                       flash_attn._DTYPE_CODE[q.dtype], hd ** -0.5)
        return qs, ks, vt


def flash_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_off: int, k_off: int):
    """One ring step's partial attention.  q: ``(B, Sq, H, hd)``, the local
    query shard at absolute position ``q_off``; k, v: ``(B, Skv, H, hd)``,
    the resident KV shard at ``k_off``; f32 or bf16.  Returns ``(acc, m,
    l)``: the unnormalised output ``(B, Sq, H, hd)`` and the softmax state
    ``(B, Sq, H)``, all f32.  On the card: the split pass, then the
    partial over its planes."""
    where = _check_partial(q, k, v)
    B, Sq, H, hd = q.shape
    with counter.charge("flash_partial", lambda: counter.partial_work(
            B, Sq, k.shape[1], H, hd, q.element_size(), q_off, k_off)):
        if where == "cpu":
            return flash_partial_plain(q, k, v, q_off=q_off, k_off=k_off)
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        if where == "meta":
            return acc, m, l
        qs, ks, vt = flash_partial_split(q, k, v)
        ops.launch("flash_partial", "ishmem_flash_partial", q.get_device(),
                   qs.data_ptr(), ks.data_ptr(), vt.data_ptr(),
                   acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, Sq,
                   k.shape[1], H, hd, int(q_off), int(k_off),
                   int(q.dtype == torch.float32))
        return acc, m, l


def merge_partials(parts):
    """Combine per-shard ``(acc, m, l)`` partials into the softmax-correct
    output: ``m* = max m_i``, ``l* = sum l_i e^{m_i - m*}``,
    ``o = sum acc_i e^{m_i - m*} / l*``."""
    ms = torch.stack([m for _, m, _ in parts])          # (n, B, Sq, H)
    m_tot = ms.amax(0)
    w = torch.exp(ms - m_tot[None])
    l_tot = (torch.stack([l for _, _, l in parts]) * w).sum(0)
    acc = torch.stack([a for a, _, _ in parts])         # (n, B, Sq, H, hd)
    out = (acc * w[..., None]).sum(0)
    return out / torch.clamp(l_tot, min=1e-30)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   npes: int):
    """Sequence-parallel causal attention: PE i holds q/k/v shard i, and at
    ring step t computes a K10 partial against KV shard ``(i - t) mod
    npes``, skipping future shards (j > i); the partials merge per PE.
    q, k, v: ``(B, S, H, hd)``, equal head counts, ``S % npes == 0``.
    Returns ``(B, S, H, hd)`` in q's dtype, equal to full causal attention
    up to the order of the softmax sums."""
    B, S, H, hd = q.shape
    if S % npes:
        raise ValueError(f"ring_attention: S={S} does not shard over "
                         f"{npes} PEs")
    Sh = S // npes
    outs = []
    for i in range(npes):
        parts = []
        for t in range(npes):
            j = (i - t) % npes
            if j > i:                    # future shard: fully masked, skip
                continue
            parts.append(flash_partial(
                q[:, i * Sh:(i + 1) * Sh].contiguous(),
                k[:, j * Sh:(j + 1) * Sh].contiguous(),
                v[:, j * Sh:(j + 1) * Sh].contiguous(),
                q_off=i * Sh, k_off=j * Sh))
        outs.append(merge_partials(parts))
    return torch.cat(outs, dim=1).to(q.dtype)
