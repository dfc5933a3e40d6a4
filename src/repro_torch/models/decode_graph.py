"""The decode step replayed as captured CUDA graphs.

On the card the eager decode step is paced by the host: it issues a few
hundred small kernels a layer (norms, rotary, projections, the one-hot
cache write, f32 attention, the MLP or the experts), and the card waits
between them.  A :class:`DecodeGraph` captures the step once and replays
it: the same kernels on the same tensors, so the tokens, logits and cache
are bitwise the eager step's.

A graph reads and writes fixed addresses, so a holder owns, for one key
(:func:`graph_key`: the bank's slot count, the cache's shapes and dtypes,
the weights, and the policy fields decode reads):

- the static inputs: the token and position, and every cache leaf; the
  leaves named ``persistent`` are adopted as they come at capture (the
  engine's paged-leaf buffers, which ``PagedDecodeView.assemble`` fills in
  place every step), the others are copied in before each replay;
- the graphs, captured into one memory pool, and their outputs.

The first call warms the eager body up on a side stream (cuBLAS's
workspace for that stream, the allocator's blocks), then captures it.
Capture follows the model's part marks (``obs/layerspans.py``): each part
(a latent-attention model's ``mla`` and ``moe`` of every layer) is a graph
of its own, and the work between parts (the embedding, a dense MLP, the
head and the stacked cache) is a graph too, so a replay runs each part
under its ``record_function`` range and its wall span where the current
marks record them.  A model that marks no parts is one graph.  The MoE's
routing (``models/moe.py::moe_ffn_dropless``) is kept as the
graph's own tensors and read back once after the replay, only where a
timed tracer counts it.

:func:`eager_reason` says where the graph engages: tensors on a CUDA
device and every layer kind one whose replay has been held bitwise to the
eager step on the card (:data:`GRAPH_KINDS`).  The engine runs it on the
paged path only (``Engine.decode_slots_paged``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import warnings
from typing import Dict, Optional

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.launch import policy as policy_mod
from repro_torch.models import model as model_mod, moe as moe_mod
from repro_torch.obs import layerspans

#: layer kinds whose replayed decode step is bitwise the eager one on the
#: card (``tests/test_torch_cuda.py``)
GRAPH_KINDS = frozenset({"attn", "mla", "mla_moe"})


@dataclasses.dataclass
class DecodeGraphTally:
    """How often the decode graph engaged: graphs captured, steps replayed
    (a capture's step replays too), and eager steps by the reason the
    graph did not engage (:func:`eager_reason`, or ``dense`` for the
    slot bank's dense cache)."""
    captures: int = 0
    replays: int = 0
    eager_steps: Dict[str, int] = dataclasses.field(default_factory=dict)

    def eager(self, reason: str) -> None:
        self.eager_steps[reason] = self.eager_steps.get(reason, 0) + 1

    def counter(self) -> dict:
        """The tally as a trace counter's numbers."""
        out = {"captures": self.captures, "replays": self.replays,
               "eager_steps": sum(self.eager_steps.values())}
        out.update({f"eager_{r}": n for r, n in self.eager_steps.items()})
        return out


def eager_reason(cfg, device, num_slots: int) -> Optional[str]:
    """None where a paged decode step of ``num_slots`` rows replays as a
    graph; else why it runs eagerly, the first that holds of:
    ``layer_kind`` (a kind outside :data:`GRAPH_KINDS`), the device type
    (``cpu``, ``meta``), ``moe_batch`` (a dropless MoE over more rows than
    it routes without reading its counts on the host)."""
    kinds = set(cfgbase.layer_kinds(cfg))
    if not kinds <= GRAPH_KINDS:
        return "layer_kind"
    if device.type != "cuda":
        return device.type
    if "mla_moe" in kinds and num_slots > moe_mod.DROPLESS_STATIC_TOKENS:
        return "moe_batch"
    return None


def graph_key(params, cache, num_slots: int) -> tuple:
    """What a captured step depends on besides its input values."""
    pol = policy_mod.get()
    leaves = tuple((ui, key, tuple(leaf.shape), leaf.dtype)
                   for ui, entry in enumerate(cache["blocks"])
                   for key, leaf in sorted(entry.items()))
    return (num_slots, leaves, id(params), pol.attn_repeat_kv,
            pol.decode_onehot_update)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class _Segments:
    """The step's marks while it is captured (``layerspans.use``): each
    part the model marks ends the graph being captured and begins its own,
    and every MoE call's routing is kept as tensors."""
    counting = True

    def __init__(self, pool):
        self.pool = pool
        self.graphs = []            # (part name or None, CUDAGraph)
        self.routes = []            # the routing of each MoE call
        self._open = None

    def begin(self, name=None) -> None:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool)
        self._open = (name, graph)

    def end(self) -> None:
        name, graph = self._open
        self._open = None
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            graph.capture_end()
        # a boundary with no kernel between two parts captures nothing
        empty = [w for w in seen if "empty" in str(w.message)]
        for w in seen:
            if w not in empty:
                warnings.warn(w.message)
        if not empty:
            self.graphs.append((name, graph))

    def abort(self) -> None:
        if self._open is not None:
            with contextlib.suppress(Exception):
                self._open[1].capture_end()
            self._open = None

    @contextlib.contextmanager
    def part(self, name: str):
        self.end()
        self.begin(name)
        yield
        self.end()
        self.begin()

    def routing(self, **route) -> None:
        self.routes.append(route)


class DecodeGraph:
    """The captured decode step of one key; ``persistent`` names the cache
    leaves ``(unit index, key)`` whose tensors stay where they are from
    step to step."""

    def __init__(self, persistent=frozenset()):
        self.persistent = frozenset(persistent)
        self.graphs = None

    @property
    def ready(self) -> bool:
        return self.graphs is not None

    def _own(self, cache) -> dict:
        """``cache`` with its leaves other than the persistent ones copied."""
        return {"blocks": [
            {key: (leaf if (ui, key) in self.persistent else leaf.clone())
             for key, leaf in entry.items()}
            for ui, entry in enumerate(cache["blocks"])]}

    def run(self, params, cfg, token, pos, cache):
        """The step's ``(logits, new cache)``: captured on the first call,
        replayed on every call.  The logits and the new cache's persistent
        leaves are the graph's own outputs, overwritten by the next replay;
        the other leaves are copies."""
        if not self.ready:
            self._capture(params, cfg, token, pos, cache)
        self._load(token, pos, cache)
        for name, graph in self.graphs:
            with layerspans.part(name) if name else contextlib.nullcontext():
                graph.replay()
        spans = layerspans.current()
        if spans is not None and spans.counting and self.routes:
            for counts in self._read_routes():
                spans.counter("moe", **counts)
        return self.logits, self._own(self.out_cache)

    def _load(self, token, pos, cache) -> None:
        self.tok.copy_(token)
        self.pos.copy_(pos)
        for entry, mine in zip(cache["blocks"], self.cache["blocks"]):
            for key, leaf in entry.items():
                if not _same(leaf, mine[key]):
                    mine[key].copy_(leaf)

    def _capture(self, params, cfg, token, pos, cache) -> None:
        self.tok, self.pos = token.clone(), pos.clone()
        self.cache = self._own(cache)
        stream = torch.cuda.Stream(device=token.device)
        stream.wait_stream(torch.cuda.current_stream(token.device))
        with torch.cuda.stream(stream), layerspans.use(None):
            # the eager step once on the capture's stream, unmarked: its
            # lazy set-up happens here, outside the capture
            model_mod._decode_step(params, cfg, self.tok, self.pos,
                                   self.cache)
        torch.cuda.current_stream(token.device).wait_stream(stream)
        torch.cuda.synchronize(token.device)
        gc.collect()
        torch.cuda.empty_cache()
        seg = _Segments(torch.cuda.graph_pool_handle())
        with torch.cuda.stream(stream), layerspans.use(seg):
            seg.begin()
            try:
                self.logits, self.out_cache = model_mod._decode_step(
                    params, cfg, self.tok, self.pos, self.cache)
                seg.end()
            except BaseException:
                seg.abort()
                raise
        torch.cuda.current_stream(token.device).wait_stream(stream)
        self.graphs, self.routes = seg.graphs, seg.routes

    def _read_routes(self) -> list:
        """Each MoE call's routing counts, read in one copy to the host."""
        assign = torch.stack([r["assign"] for r in self.routes])
        over = torch.stack([(r["rank"] >= r["capacity"]).sum()
                            for r in self.routes])
        rows = torch.stack([assign.max(-1).values, (assign > 0).sum(-1),
                            over]).T.tolist()
        return [dict(tokens=r["tokens"], max_per_expert=m,
                     experts_touched=t, dropped=d)
                for r, (m, t, d) in zip(self.routes, rows)]
