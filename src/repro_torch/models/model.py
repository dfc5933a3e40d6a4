"""Model assembly for every block kind of the ten configurations
(counterpart of ``repro/models/model.py``).

``init_params(cfg)`` builds a nested dict with the reference's key names;
per-layer weights are stacked over the repeats of the layer unit (axis 0),
and the forward passes loop over the repeats.  Block kinds: ``attn``,
``shared_attn`` (zamba2's one weight-shared attention block lives at
``params["shared_attn"]``, unstacked, with a ``{}`` placeholder at its
position in ``params["blocks"]``; every repeat keeps its own K/V cache),
``moe`` (attention and the routed experts of ``models/moe.py``),
``mla`` and ``mla_moe`` (DeepSeek-V2: multi-head latent attention of
``models/attention.py``, then a dense MLP of ``first_dense_ff`` or the
dropless routed and shared experts of ``models/moe.py``),
``encdec`` (whisper's decoder: self-attention, cross-attention over the
encoder output, MLP; the encoder's stacked ``attn`` blocks live at
``params["encoder"]``), ``cross`` (the vision model's gated
cross-attention over image embeddings, scaled by ``tanh(gate)``),
``mamba``, ``mlstm`` and ``slstm``.  Three step kinds:

- ``train_loss``  : full-sequence teacher-forced LM loss with the
  reference's chunked CE head, and the MoE's auxiliary loss;
- ``prefill``     : full-prompt forward that fills the decode cache (and
  runs the frontends: the encoder over ``batch["audio_embeds"]``, or
  ``batch["image_embeds"]`` cast to the activation dtype);
- ``decode_step`` : ONE token against the cache (cross K/V come from it).

Prefill self-attention goes through the K2 flash kernel (its plain
version for CPU tensors) under either ``attn_impl``, except under a
sliding window, which the reference computes in plain JAX
(``blockwise_causal_attn``) and so does the port.  Training follows the
policy: under the default ("blockwise") ``full_attn`` under a causal mask
up to 1024 tokens with no window, else ``blockwise_causal_attn``; under
"flash" its forward goes through K2, which has no backward in either
package, so a gradient through it raises ``NotImplementedError``.  Under
``attn_repeat_kv`` the K/V heads are repeated to the query heads before
every attention but the decode kernel's, which shares each K/V head among
its query heads itself (the cache keeps them unrepeated).  With
``cfg.remat`` each repeat of the layer unit is recomputed in the backward
pass (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).  A
ring cache (SWA, or a hybrid above 65,536 tokens) keeps the last
``window`` positions of the prompt, and decode writes slot ``pos % W`` and
reads the slots whose ``kpos`` lies in the window.  Decode attention over
a bf16 cache that is not a ring goes through ``kernels/decode_attn.py``
(its plain version on the CPU); over the paged step's block payload (K
and V as ``(B, nb, T, nkv, hd)`` views, the payload form of
``serve/paged_attn.py``) it stores the new column in place and returns no
K/V leaf.  ``shardctx.constrain`` sits at the reference's four sites (the
gathered weights under ``fsdp_gather_weights``, the hidden state after
each repeat and after the embedding, the CE chunk's logits); with no GSPMD
it returns its input and only records the spec the dry-run's rules give.
Every step runs on ``meta`` tensors too (``init_params(device="meta")``),
which is how the dry-run counts its work.  The latent-attention blocks
mark their attention and MoE as ``<step>.mla`` and ``<step>.moe`` on the
marks the caller made current (``obs/layerspans.py``), and the MoE reports
its routing there.  ``decode_step`` also takes a captured graph of itself
(``models/decode_graph.py``), which it replays instead of issuing the step
eagerly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import _devices
from repro_torch.configs import base as cfgbase
from repro_torch.kernels import decode_attn, flash_attn
from repro_torch.launch import policy as policy_mod, shardctx
from repro_torch.models import attention as attn_mod, kvcache, \
    moe as moe_mod, ssm as ssm_mod
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp, \
    rms_norm
from repro_torch.obs import layerspans

_SELF_ATTN = ("attn", "shared_attn", "moe", "encdec")
_MLA = ("mla", "mla_moe")


def _init_block(gen, kind, cfg, dtype, reps, dev):
    d = cfg.d_model

    def ones():
        return torch.ones((reps, d), dtype=dtype, device=dev)

    def attn():
        return attn_mod.init_attn(gen, cfg, dtype, reps=reps, device=dev)

    def mlp():
        return init_mlp(gen, d, cfg.d_ff, cfg.mlp_type, dtype, reps=reps,
                        device=dev)

    if kind in ("attn", "shared_attn"):
        bp = {"norm1": ones(), "attn": attn()}
        if cfg.d_ff:
            bp["norm2"] = ones()
            bp["mlp"] = mlp()
        return bp
    if kind == "moe":
        return {"norm1": ones(), "attn": attn(), "norm2": ones(),
                "moe": moe_mod.init_moe(gen, cfg, dtype, reps=reps,
                                        device=dev)}
    if kind in _MLA:
        bp = {"norm1": ones(),
              "attn": attn_mod.init_mla(gen, cfg, dtype, reps=reps,
                                        device=dev),
              "norm2": ones()}
        if kind == "mla":
            bp["mlp"] = init_mlp(gen, d, cfg.first_dense_ff, cfg.mlp_type,
                                 dtype, reps=reps, device=dev)
        else:
            bp["moe"] = moe_mod.init_moe(gen, cfg, dtype, reps=reps,
                                         device=dev)
        return bp
    if kind == "encdec":
        return {"norm1": ones(), "attn": attn(), "norm_x": ones(),
                "cross": attn(), "norm2": ones(), "mlp": mlp()}
    if kind == "cross":
        return {"norm1": ones(), "cross": attn(),
                "gate": torch.zeros((reps,), dtype=torch.float32, device=dev),
                "norm2": ones(), "mlp": mlp()}
    init = {"mamba": ssm_mod.init_mamba, "mlstm": ssm_mod.init_mlstm,
            "slstm": ssm_mod.init_slstm}[kind]
    return init(gen, cfg, dtype, reps=reps, device=dev)


def init_params(cfg, *, seed: int = 0, device=None) -> dict:
    """Random weights with the reference's distributions (``dense_init``),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the current CUDA device unless given).  On ``meta`` the leaves are
    empty and nothing is drawn (a meta generator does not exist)."""
    dev = _devices.resolve(device)
    unit, reps = cfgbase.repeat_unit(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params = {
        "embed": dense_init(gen, (cfg.vocab_size, d), scale=0.02,
                            dtype=dtype, device=dev),
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype,
                                       device=dev)
    blocks = []
    for kind in unit:
        if kind == "shared_attn":
            # zamba2: ONE weight-shared attention block used at every repeat
            params["shared_attn"] = _layer(
                _init_block(gen, kind, cfg, dtype, 1, dev), 0)
            blocks.append({})          # placeholder slot in the stack
            continue
        blocks.append(_init_block(gen, kind, cfg, dtype, reps, dev))
    params["blocks"] = blocks
    if cfg.family == "audio":
        params["encoder"] = {
            "blocks": _init_block(gen, "attn", cfg, dtype,
                                  cfg.encoder_layers, dev),
            "final_norm": ones(d)}
    return params


def _layer(tree, r):
    """Repeat ``r`` of a stacked parameter or cache tree."""
    return _map(lambda leaf: leaf[r], tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat(o):
    return o.reshape(o.shape[0], o.shape[1], -1)


def _repeat_kv(cfg, k, v):
    """``attn_repeat_kv``: each K/V head repeated ``q_per_kv`` times along
    the head axis in ``jnp.repeat`` order, so attention runs as MHA."""
    if policy_mod.get().attn_repeat_kv and cfg.q_per_kv > 1:
        k = k.repeat_interleave(cfg.q_per_kv, dim=2)
        v = v.repeat_interleave(cfg.q_per_kv, dim=2)
    return k, v


def _flash(q, k, v):
    """K2 on a path that may be differentiated.  The reference passes its
    kernel ``block_q/k = min(attn_block_q/k, 256)``; K2 and its plain
    version take no block size, and the function does not depend on one.
    K2 has no backward, nor has the reference's Pallas kernel (its
    ``pallas_call`` JVP rule fails), so a gradient through it raises
    instead of taking another attention."""
    if torch.is_grad_enabled() and q.requires_grad:
        raise NotImplementedError(
            "attn_impl='flash' cannot train: the flash kernel (K2) is "
            "forward-only, as is the reference's Pallas kernel, whose "
            "pallas_call has no JVP rule to differentiate through; train "
            "under attn_impl='blockwise'")
    return flash_attn.flash_attention(q, k, v)


def _self_attention(p, x, cfg, mode, positions, cache, pos):
    """Returns (attn_out, new cache entries)."""
    window = cfg.window if cfg.attention == "swa" else None
    if mode in ("train", "prefill"):
        q = attn_mod.project_q(p, x, cfg, positions)
        k, v = attn_mod.project_kv(p, x, cfg, positions)
        kr, vr = _repeat_kv(cfg, k, v)
        S = x.shape[1]
        flash = window is None and (
            mode == "prefill" or policy_mod.get().attn_impl == "flash")
        if flash:                  # K2; a train step only under "flash"
            o = _flash(q, kr, vr)
        elif S <= 1024 and window is None:
            causal = torch.ones((S, S), dtype=torch.bool,
                                device=x.device).tril()
            o = attn_mod.full_attn(q, kr, vr, mask=causal[None, None, None])
        else:
            o = attn_mod.blockwise_causal_attn(q, kr, vr, window=window)
        new = {}
        if cache is not None:
            W = cache["k"].shape[1]
            # dense: slots [0, S); ring: the last min(W, S) positions at
            # slot position % W; the cache keeps the unrepeated heads
            kpos = torch.arange(S - min(W, S), S, device=x.device)
            slots = kpos % W
            for key, val in (("k", k), ("v", v)):
                new[key] = torch.zeros_like(cache[key])
                new[key][:, slots] = val[:, kpos].to(cache[key].dtype)
            if "kpos" in cache:
                new["kpos"] = torch.full_like(cache["kpos"], -1)
                new["kpos"][:, slots] = kpos.to(torch.int32)
        return _flat(o) @ p["wo"], new
    # ---- decode: one token per row at its own position -------------------
    q = attn_mod.project_q(p, x, cfg, pos[:, None])
    k, v = attn_mod.project_kv(p, x, cfg, pos[:, None])
    if cache["k"].dim() == 5:
        # the paged step's payload form (serve/paged_attn.py): K and V are
        # (B, nb, T, nkv, hd) views of the gathered block payload; the new
        # column is stored there in place, and no leaf comes back to stack
        dt = cache["k"].dtype
        o = decode_attn.decode_attention(q, cache["k"], cache["v"], pos,
                                         k_new=k.to(dt), v_new=v.to(dt))
        return _flat(o) @ p["wo"], {}
    W = cache["k"].shape[1]
    ring = "kpos" in cache
    slot = pos % W if ring else pos
    # one-hot select, not a scatter: a dense position past the cache is
    # dropped (the reference's out-of-bounds rule) and the write needs no
    # sync.  This is the reference's decode_onehot_update branch, and for
    # every position its scatter branch writes the same cache, so the
    # field changes nothing here
    hot = torch.arange(W, device=pos.device)[None, :] == slot[:, None]
    new = {key: torch.where(hot[:, :, None, None], val.to(cache[key].dtype),
                            cache[key])
           for key, val in (("k", k), ("v", v))}
    if not ring and new["k"].dtype == torch.bfloat16:
        o = decode_attn.decode_attention(q, new["k"], new["v"], pos)
        return _flat(o) @ p["wo"], new
    if ring:
        kpos = torch.where(hot, pos[:, None].to(torch.int32), cache["kpos"])
        valid = (kpos >= 0) & (kpos > (pos - W)[:, None]) & \
            (kpos <= pos[:, None])
        new["kpos"] = kpos
    else:
        valid = torch.arange(W, device=pos.device)[None, :] <= pos[:, None]
    kr, vr = _repeat_kv(cfg, new["k"], new["v"])
    o = attn_mod.decode_attn(q, kr, vr, valid)
    return _flat(o) @ p["wo"], new


def _cross_attention(bp, x, cfg, mode, kv_source=None, cache=None):
    """Cross-attention (whisper's decoder, the vision model's image
    layers).  ``kv_source``: (B, Skv, d) encoder output or image
    embeddings at prefill; at decode the projected K/V come from the
    cache.  Returns (out, new cache entries)."""
    p = bp["cross"]
    q = attn_mod.project_q(p, x, cfg, None)
    if mode in ("train", "prefill"):
        ck, cv = attn_mod.project_kv(p, kv_source, cfg, None)
        new = {} if cache is None else {
            "ck": ck.to(cache["ck"].dtype), "cv": cv.to(cache["cv"].dtype)}
    else:
        ck, cv = cache["ck"], cache["cv"]
        new = {"ck": ck, "cv": cv}
    o = attn_mod.full_attn(q, ck, cv)
    return _flat(o) @ p["wo"], new


def _check_mode(mode):
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")


def _mla_block(kind, bp, x, cfg, mode, positions, cache, pos):
    """Latent attention, then the dense MLP (``mla``) or the dropless
    routed and shared experts (``mla_moe``), both residual."""
    aux = None
    with layerspans.part("mla"):
        h = rms_norm(x, bp["norm1"])
        if mode == "decode":
            o, new_cache = attn_mod.mla_decode(bp["attn"], h, cfg, pos,
                                               cache)
        else:
            o, new_cache = attn_mod.mla_prefill(bp["attn"], h, cfg,
                                                positions, cache)
        x = x + o
    if kind == "mla":
        return x + apply_mlp(bp["mlp"], rms_norm(x, bp["norm2"]),
                             cfg.mlp_type), new_cache, aux
    with layerspans.part("moe"):
        h = rms_norm(x, bp["norm2"])
        B, S, d = h.shape
        y, aux = moe_mod.moe_ffn_dropless(bp["moe"], h.reshape(B * S, d),
                                          cfg)
        x = x + y.reshape(B, S, d)
    return x, new_cache, aux


def apply_block(kind, bp, x, *, cfg, mode, positions=None, cache=None,
                enc_out=None, image_embeds=None, pos=None):
    """Returns (x_out, new cache entries, aux): the MoE's load-balance loss
    (f32 scalar), None for the other kinds (the reference's zero).  Prefill
    starts every recurrent state from zero, as the reference does, and
    returns the end state; training keeps no cache."""
    _check_mode(mode)
    aux = None
    if kind in _MLA:
        return _mla_block(kind, bp, x, cfg, mode, positions, cache, pos)
    if kind in _SELF_ATTN:
        h = rms_norm(x, bp["norm1"])
        o, new_cache = _self_attention(bp["attn"], h, cfg, mode, positions,
                                       cache, pos)
        x = x + o
        if kind == "encdec":
            o, nc = _cross_attention(bp, rms_norm(x, bp["norm_x"]), cfg,
                                     mode, enc_out, cache)
            x = x + o
            new_cache.update(nc)
        if kind == "moe":
            h = rms_norm(x, bp["norm2"])
            B, S, d = h.shape
            y, aux = moe_mod.moe_ffn(bp["moe"], h.reshape(B * S, d), cfg)
            x = x + y.reshape(B, S, d)
        elif cfg.d_ff:
            x = x + apply_mlp(bp["mlp"], rms_norm(x, bp["norm2"]),
                              cfg.mlp_type)
        return x, new_cache, aux
    if kind == "cross":
        o, new_cache = _cross_attention(bp, rms_norm(x, bp["norm1"]), cfg,
                                        mode, image_embeds, cache)
        x = x + torch.tanh(bp["gate"]).to(x.dtype) * o
        x = x + apply_mlp(bp["mlp"], rms_norm(x, bp["norm2"]), cfg.mlp_type)
        return x, new_cache, aux
    h = rms_norm(x, bp["norm"])
    if kind == "mamba":
        if mode == "decode":
            y, state, conv = ssm_mod.mamba_decode(bp, h, cfg, cache["state"],
                                                  cache["conv"])
        else:
            y, state, conv = ssm_mod.mamba_forward(bp, h, cfg)
        return x + y, {"state": state, "conv": conv}, aux
    if kind == "mlstm":
        if mode == "decode":
            y, st = ssm_mod.mlstm_decode(bp, h, cfg, (cache["C"], cache["n"],
                                                      cache["m"]))
        else:
            y, st = ssm_mod.mlstm_forward(bp, h, cfg)
        return x + y, dict(zip(("C", "n", "m"), st)), aux
    if kind == "slstm":
        if mode == "decode":
            y, st = ssm_mod.slstm_decode(
                bp, h, cfg, tuple(cache[k] for k in "cnmh"))
        else:
            y, st = ssm_mod.slstm_forward(bp, h, cfg)
        return x + y, dict(zip("cnmh", st)), aux
    raise ValueError(kind)


def backbone(params, cfg, x, *, mode, positions=None, cache=None,
             enc_out=None, image_embeds=None, pos=None):
    """x: (B,S,d) embedded inputs.  Returns (x, new_cache, aux), aux the
    f32 sum of the blocks' auxiliary losses in the reference's order
    (repeat by repeat, block by block)."""
    _check_mode(mode)
    unit, reps = cfgbase.repeat_unit(cfg)
    shared = params.get("shared_attn")
    new_blocks = [{} for _ in (unit if cache is None else cache["blocks"])]

    gather = policy_mod.get().fsdp_gather_weights

    def unit_body(r, x, aux):
        for i, kind in enumerate(unit):
            bp = shared if kind == "shared_attn" else \
                _layer(params["blocks"][i], r)
            if gather:
                bp = _map(lambda w: shardctx.constrain(w, "gathered_weight"),
                          bp)
            ci, cr = kvcache.entry_of(cfg, len(unit), i, r)
            c = _layer(cache["blocks"][ci], cr) if cache is not None \
                else None
            x, nc, a = apply_block(kind, bp, x, cfg=cfg, mode=mode,
                                   positions=positions, cache=c,
                                   enc_out=enc_out, image_embeds=image_embeds,
                                   pos=pos)
            if mode != "train":
                for key, leaf in nc.items():
                    new_blocks[ci].setdefault(key, []).append(leaf)
            if a is not None:              # 0 + a is a: start from the first
                aux = a if aux is None else aux + a
        return shardctx.constrain(x, "hidden"), aux

    remat = cfg.remat and mode == "train"
    aux = None
    for r in range(reps):
        if remat:
            # no unit draws a random number, so there is no RNG state to
            # keep (forking the card's would add ops a meta run lacks)
            x, aux = torch.utils.checkpoint.checkpoint(
                unit_body, r, x, aux, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux = unit_body(r, x, aux)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is None:
        return x, None, aux
    return x, {"blocks": [{k: torch.stack(v) for k, v in b.items()}
                          for b in new_blocks]}, aux


def _encoder_forward(params, cfg, audio_embeds):
    """Whisper's audio encoder over the stubbed frame embeddings
    (bidirectional attention, no positions)."""
    enc = params["encoder"]
    x = audio_embeds.to(cfg.activation_dtype())
    for r in range(cfg.encoder_layers):
        bp = _layer(enc["blocks"], r)
        h = rms_norm(x, bp["norm1"])
        q = attn_mod.project_q(bp["attn"], h, cfg, None)
        k, v = attn_mod.project_kv(bp["attn"], h, cfg, None)
        x = x + _flat(attn_mod.full_attn(q, k, v)) @ bp["attn"]["wo"]
        x = x + apply_mlp(bp["mlp"], rms_norm(x, bp["norm2"]), cfg.mlp_type)
    return rms_norm(x, enc["final_norm"])


def _frontends(params, cfg, batch):
    enc_out = image_embeds = None
    if cfg.family == "audio":
        enc_out = _encoder_forward(params, cfg, batch["audio_embeds"])
    if cfg.family == "vlm":
        image_embeds = batch["image_embeds"].to(cfg.activation_dtype())
    return enc_out, image_embeds


def _embed(params, cfg, tokens):
    # F.embedding gathers the rows as indexing does; its backward on the
    # card sums each row's contributions in f32 and in a fixed order,
    # where indexing's adds them with atomics in the table's dtype (a
    # frequent token's bf16 row then loses most of its small addends)
    x = F.embedding(tokens, params["embed"]).to(cfg.activation_dtype())
    return shardctx.constrain(x, "hidden")


def _lm_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def train_loss(params, cfg, batch):
    """batch: tokens (B,S), labels (B,S) [+ frontend embeds].  Returns
    (loss, {"ce", "aux"}).  The head runs over sequence chunks of
    ``policy.ce_chunk`` (or the largest of 512, 256 and 128 that divides
    S), its logits in bf16 under ``logits_bf16``, the logsumexp in f32."""
    tokens, labels = batch["tokens"], batch["labels"].long()
    B, S = tokens.shape
    enc_out, image_embeds = _frontends(params, cfg, batch)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, _, aux = backbone(params, cfg, x, mode="train", positions=positions,
                         enc_out=enc_out, image_embeds=image_embeds)
    x = rms_norm(x, params["final_norm"])

    pol = policy_mod.get()
    W = _lm_matrix(params, cfg)
    want = pol.ce_chunk
    C = S if S <= want else max(c for c in (want, 512, 256, 128)
                                if c <= want and S % c == 0)
    ldt = torch.bfloat16 if pol.logits_bf16 else torch.float32
    total = None
    for c0 in range(0, S, C):
        logits = shardctx.constrain((x[:, c0:c0 + C] @ W).to(ldt), "logits")
        lse = torch.logsumexp(logits.float(), dim=-1)
        ll = torch.gather(logits, -1,
                          labels[:, c0:c0 + C, None])[..., 0].float()
        term = torch.sum(lse - ll)
        total = term if total is None else total + term
    ce = total / (B * S)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params, cfg, batch, cache):
    """Fill the cache from a full prompt (``batch["tokens"]``, plus the
    family's frontend embeddings); returns (last_logits f32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out, image_embeds = _frontends(params, cfg, batch)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, new_cache, _ = backbone(params, cfg, x, mode="prefill",
                               positions=positions, cache=cache,
                               enc_out=enc_out, image_embeds=image_embeds)
    x = rms_norm(x[:, -1:], params["final_norm"])
    logits = (x @ _lm_matrix(params, cfg)).float()
    return logits[:, 0], new_cache


def decode_step(params, cfg, token, pos, cache, graph=None):
    """ONE token (B,1) at positions pos (B,) against the cache.  With
    ``graph`` (a ``models/decode_graph.py::DecodeGraph``) the step is that
    graph's replay, captured from :func:`_decode_step` on its first call."""
    if graph is not None:
        return graph.run(params, cfg, token, pos, cache)
    return _decode_step(params, cfg, token, pos, cache)


def _decode_step(params, cfg, token, pos, cache):
    """The eager body of :func:`decode_step`."""
    x = _embed(params, cfg, token)
    x, new_cache, _ = backbone(params, cfg, x, mode="decode", cache=cache,
                               pos=pos)
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _lm_matrix(params, cfg)).float()
    return logits[:, 0], new_cache
