"""Slot-based serving engine (counterpart of ``repro/serve/engine.py``).

The decode cache is a fixed bank of ``num_slots`` request slots; requests
enter a slot mid-flight and leave it the step they finish.  One decode step
always runs the whole bank; inactive slots carry ``pos=0, tok=0`` padding
whose cache writes are masked or overwritten at the next admission.  The
engine runs eagerly (no ``jit``), except the paged decode step on a card:
where ``models/decode_graph.py::eager_reason`` allows, it replays as CUDA
graphs captured on a bank shape's first step, over paged leaves rebuilt
each step in persistent buffers (``serve/paged_attn.py::leaf_buffers``).
Prefill, the dense decode path and the families no graph has been held
bitwise to run eagerly.

Sampling with temperature > 0 draws from a ``torch.Generator`` the caller
passes (seeded from ``ServeConfig.seed``); its numbers differ from
``jax.random``'s, so only greedy decoding compares across packages.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import _devices
from repro_torch.models import decode_graph, kvcache, model
from repro_torch.obs import layerspans
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve import kvpool, paged_attn
from repro_torch.train import tree


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    eos_id: int = -1               # -1 = never stop early
    seed: int = 0


@dataclasses.dataclass
class SlotBatch:
    """State of one decode slot bank (steps return a new one)."""
    cache: dict                    # batched decode cache, B = num_slots
    pos: torch.Tensor              # (B,) int64 — next decode position
    tok: torch.Tensor              # (B,) int64 — last sampled token
    active: np.ndarray             # (B,) bool, host-side occupancy mask

    @property
    def num_slots(self) -> int:
        return int(self.pos.shape[0])


def seeded(device, *parts: int) -> torch.Generator:
    """A generator seeded from integer parts (seed, request id, step...)."""
    seed = 0
    for p in parts:
        seed = (seed * 1_000_003 + int(p)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


class Engine:
    def __init__(self, cfg_arch, params, *, max_len: int, device=None):
        self.device = _devices.resolve(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        self.cfg = cfg_arch
        self.params = params
        self.max_len = max_len
        self._leaves = {}          # paged-leaf buffers by bank shape
        self._graphs = {}          # DecodeGraph by decode_graph.graph_key

    def _sample(self, logits, gen: Optional[torch.Generator],
                temperature: float):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    # ------------------------------------------------------------ slot API
    def init_slots(self, num_slots: int, paged: bool = False) -> SlotBatch:
        """An empty bank; ``paged`` leaves out the leaves the block pool
        pages, which the paged decode step rebuilds from the pool."""
        zeros = torch.zeros(num_slots, dtype=torch.int64, device=self.device)
        skip = kvpool.build_layout(self.cfg, self.max_len).paged_keys \
            if paged else frozenset()
        return SlotBatch(
            cache=kvcache.init_cache(self.cfg, num_slots, self.max_len,
                                     self.device, skip=skip),
            pos=zeros, tok=zeros.clone(),
            active=np.zeros((num_slots,), bool))

    def prefill_request(self, request: dict, gen=None,
                        temperature: float = 0.0):
        """Prefill ONE request (batch axis 1).  Returns ``(first_token,
        logits, cache1)``: the B=1 cache a migration packs from, and the
        token sampled from the last position.  The model's layers mark
        their parts on the current marks (``obs/layerspans.py``)."""
        S = request["tokens"].shape[1]
        if S > self.max_len:
            raise ValueError(f"prompt of {S} exceeds the cache ({self.max_len})")
        cache = kvcache.init_cache(self.cfg, 1, self.max_len, self.device)
        logits, cache = model.prefill(self.params, self.cfg, request, cache)
        tok = self._sample(logits, gen, temperature)
        return int(tok[0]), logits, cache

    def activate_slot(self, slots: SlotBatch, slot: int, *, pos: int,
                      token: int) -> SlotBatch:
        """Mark a slot occupied with its decode cursor and pending token;
        its cache contents must already be in place."""
        active = slots.active.copy()
        active[slot] = True
        new_pos, new_tok = slots.pos.clone(), slots.tok.clone()
        new_pos[slot] = pos
        new_tok[slot] = token
        return SlotBatch(cache=slots.cache, pos=new_pos, tok=new_tok,
                         active=active)

    def evict_slot(self, slots: SlotBatch, slot: int) -> SlotBatch:
        """Release a slot; pos/tok return to the inactive padding values.
        The cache rows keep their bytes (masked, then overwritten at the
        next admission)."""
        slots = self.activate_slot(slots, slot, pos=0, token=0)
        slots.active[slot] = False
        return slots

    def _advance(self, slots, cache, tok):
        mask = torch.as_tensor(slots.active, device=self.device)
        return SlotBatch(cache=cache,
                         pos=torch.where(mask, slots.pos + 1, 0),
                         tok=torch.where(mask, tok, 0),
                         active=slots.active.copy())

    def decode_slots(self, slots: SlotBatch, gen=None,
                     temperature: float = 0.0, tally=None):
        """ONE decode step over the whole bank, eagerly (counted ``dense``
        on ``tally``, a ``decode_graph.DecodeGraphTally``).  Returns
        ``(new_slots, tokens)``."""
        if tally is not None:
            tally.eager("dense")
        logits, cache = model.decode_step(self.params, self.cfg,
                                          slots.tok[:, None], slots.pos,
                                          slots.cache)
        tok = self._sample(logits, gen, temperature)
        return self._advance(slots, cache, tok), tok

    def _paged_leaves(self, view):
        """The paged-leaf buffers of ``view``'s bank shape, shared by every
        decode PE of this engine (they step one after another on one
        stream)."""
        key = (view.num_slots, view.pool.layout)
        if key not in self._leaves:
            self._leaves[key] = paged_attn.leaf_buffers(
                view.pool.layout, view.num_slots, self.device)
        return self._leaves[key]

    def _decode_graph(self, slots, cache, view, tally):
        """The captured step this paged step replays, or None (counted on
        ``tally`` by its reason) where it runs eagerly."""
        reason = decode_graph.eager_reason(self.cfg, self.device,
                                           slots.num_slots)
        if reason is not None:
            if tally is not None:
                tally.eager(reason)
            return None
        key = decode_graph.graph_key(self.params, cache, slots.num_slots)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = decode_graph.DecodeGraph(
                view.pool.layout.paged_keys)
        if tally is not None:
            tally.captures += not graph.ready
            tally.replays += 1
        return graph

    def decode_slots_paged(self, slots: SlotBatch, gen, ctx, heap, view,
                           temperature: float = 0.0, track=None,
                           tally=None):
        """ONE decode step reading K/V straight from the symmetric-heap
        block pool: the view assembles every paged leaf through the slot
        block tables (K3), the same decode runs, and each active slot's new
        K/V token is written back into its pool block.  The returned bank
        keeps only non-paged state.  Returns ``(new_slots, tokens, heap)``.
        The leaves are rebuilt in this engine's persistent buffers, and on a
        card the decode proper replays a captured graph
        (``models/decode_graph.py``) where ``eager_reason`` allows; ``tally``
        (a ``DecodeGraphTally``) counts captures, replays and eager steps.
        The decode proper runs in ``ctx.prof``'s ``paged_attn`` scope.
        With a wall-clocked tracer on ``ctx`` (``tracer.timed``), the four
        parts record ``decode.assemble``, ``decode.model``,
        ``decode.sample`` and ``decode.writeback`` spans on ``track`` (by
        default the view's PE), ``tally`` ends ``decode.model`` as a
        ``decode_graph`` counter and the heap's tally ends the writeback as
        a ``heap`` counter.  With that tracer or a recording
        ``torch.profiler``, the model's layers mark their parts inside
        ``decode.model`` (``obs/layerspans.py``)."""
        tr, pf = ctx.tracer if ctx.tracer.timed else NULL_TRACER, ctx.prof
        pid, tid = track or (f"pod{ctx.node_of(view.pe)}", f"pe{view.pe}")
        with tr.span("decode.assemble", "engine", pid, tid):
            cache = view.assemble(heap, slots.cache,
                                  out=self._paged_leaves(view))
        with tr.span("decode.model", "engine", pid, tid):
            graph = self._decode_graph(slots, cache, view, tally)
            kv_bytes = sum(leaf.numel() * leaf.element_size()
                           for leaf in tree.leaves(cache)) \
                if pf.enabled else 0
            with pf.scope("paged_attn", nbytes=kv_bytes, path="engine",
                          tier="local",
                          work_items=int(slots.active.sum())) as ps, \
                    layerspans.use(layerspans.LayerSpans.make(
                        "decode", tr, (pid, tid))):
                logits, new_cache = model.decode_step(
                    self.params, self.cfg, slots.tok[:, None], slots.pos,
                    cache, graph=graph)
                logits = ps(logits)
            if tr.enabled and tally is not None:
                tr.counter("decode_graph", pid, tid, **tally.counter())
        with tr.span("decode.sample", "engine", pid, tid):
            tok = self._sample(logits, gen, temperature)
        with tr.span("decode.writeback", "engine", pid, tid):
            heap = view.writeback(ctx, heap, new_cache, slots.pos,
                                  slots.active)
            if tr.enabled:
                tr.counter("heap", pid, tid, **dataclasses.asdict(heap.tally))
        return self._advance(slots, view.unpaged(new_cache), tok), tok, heap

    # ------------------------------------------------------- lockstep API
    def generate(self, batch, scfg: ServeConfig = ServeConfig()):
        """batch: {tokens: (B, S)}.  Returns (B, max_new_tokens) ids: every
        request admitted at step 0 (one batched prefill), decoded until
        max_new; after eos the row pads with zeros."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        if S + scfg.max_new_tokens > self.max_len + 1:
            raise ValueError("cache too small for prompt + generation")
        gen = seeded(self.device, scfg.seed)
        cache = kvcache.init_cache(self.cfg, B, self.max_len, self.device)
        logits, cache = model.prefill(self.params, self.cfg, batch, cache)
        slots = SlotBatch(cache=cache,
                          pos=torch.full((B,), S, dtype=torch.int64,
                                         device=self.device),
                          tok=self._sample(logits, gen, scfg.temperature),
                          active=np.ones((B,), bool))
        out = []
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        for _ in range(scfg.max_new_tokens):
            out.append(torch.where(done, 0, slots.tok))
            done = done | (slots.tok == scfg.eos_id)
            slots, _ = self.decode_slots(slots, gen, scfg.temperature)
        return torch.stack(out, dim=1)

    def generate_in_slot(self, batch, scfg: ServeConfig, *, num_slots: int,
                         slot: int) -> list:
        """Serve ONE request alone through the slot path, at the shapes
        disaggregated serving gives it: prefill at B=1, then decode in slot
        ``slot`` of a dense bank of ``num_slots``.  The baseline of the
        bitwise law on the card, where a GEMM row depends only on its own
        input row when the batch size is the same (greedy only).  Returns
        the ``max_new_tokens`` ids, zero-padded after eos."""
        tok, _, cache1 = self.prefill_request(batch)
        slots = self.init_slots(num_slots)
        for bank_entry, entry in zip(slots.cache["blocks"], cache1["blocks"]):
            for key, leaf in entry.items():
                bank_entry[key][:, slot] = leaf[:, 0]
        slots = self.activate_slot(slots, slot, pos=batch["tokens"].shape[1],
                                   token=tok)
        out = [tok]
        while len(out) < scfg.max_new_tokens and out[-1] != scfg.eos_id:
            slots, toks = self.decode_slots(slots)
            out.append(int(toks[slot]))
        return out + [0] * (scfg.max_new_tokens - len(out))
