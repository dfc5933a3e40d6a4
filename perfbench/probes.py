"""What a traced run records around calls into the program: CUDA events,
synchronised host stamps, ``record_function`` ranges and the shapes of
kernel calls.  Every probe wraps a call and returns what it returns; it
changes no behaviour of the program, only its timing, so probes go on in
a ``--trace 1`` run alone.

``Probes.install_serving`` patches module, class and instance attributes
and ``Probes.remove`` restores every one of them.
"""
from __future__ import annotations

import time

import torch


class Probes:
    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.recording = False      # shapes are kept while the profiler runs
        self.window = False         # CUDA events are kept inside the window
        self.gather_calls = []      # (entries, mapped, row_bytes)
        self.flash_calls = []       # (B, S, H, Hkv, hd, itemsize)
        self.prefill_events = []    # (start, end, prompt_len) CUDA events
        self.decode_events = []     # (start, end)
        self.prefill_end = {}       # rid -> synchronised host stamp
        self.admitted = {}          # rid -> synchronised host stamp
        self.batch_rid = {}         # id(request tokens) -> rid
        self._undo = []

    # ------------------------------------------------------------ helpers
    def _patch(self, owner, name, wrapper):
        orig = getattr(owner, name)
        had = name in vars(owner) if not isinstance(owner, type) else True
        self._undo.append((owner, name, orig, had))
        setattr(owner, name, wrapper(orig))

    def remove(self):
        for owner, name, orig, had in reversed(self._undo):
            if had:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        self._undo = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _events(self):
        if not self.cuda:
            return None, None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        return a, b

    @staticmethod
    def ranged(name, fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapped

    # ------------------------------------------------------------ serving
    def install_serving(self, sched):
        from repro_torch.core.heap import SymmetricHeap
        from repro_torch.kernels import flash_attn, ishmem_device
        from repro_torch.models import model

        for phase in ("_phase_prefill", "_phase_admit", "_phase_decode"):
            self._patch(sched, phase, lambda f, p=phase: self.ranged(
                f"perfbench.sched.{p[7:]}", f))
        self._patch(SymmetricHeap, "write",
                    lambda f: self.ranged("perfbench.heap_write", f))

        def gather(f):
            def wrapped(data, table):
                if self.recording:
                    t = torch.as_tensor(table)
                    self.gather_calls.append(
                        (int(t.numel()), int((t < data.shape[0]).sum()),
                         int(data.shape[1] * data.element_size())))
                return f(data, table)
            return wrapped
        self._patch(ishmem_device, "paged_gather", gather)

        def flash(f):
            def wrapped(q, k, v, *a, **kw):
                if self.recording:
                    B, S, H, hd = q.shape
                    self.flash_calls.append((B, S, H, int(k.shape[2]), hd,
                                             q.element_size()))
                return f(q, k, v, *a, **kw)
            return wrapped
        self._patch(flash_attn, "flash_attention", flash)

        def decode(f):
            def wrapped(*a, **kw):
                s, e = self._events()
                if s is not None:
                    s.record()
                with torch.profiler.record_function("perfbench.decode_step"):
                    out = f(*a, **kw)
                if e is not None:
                    e.record()
                    if self.window:
                        self.decode_events.append((s, e))
                return out
            return wrapped
        self._patch(model, "decode_step", decode)

        def prefill(f):
            def wrapped(batch, *a, **kw):
                s, e = self._events()
                if s is not None:
                    s.record()
                with torch.profiler.record_function("perfbench.prefill"):
                    out = f(batch, *a, **kw)
                if e is not None:
                    e.record()
                    if self.window:
                        self.prefill_events.append(
                            (s, e, int(batch["tokens"].shape[1])))
                self._sync()
                rid = self.batch_rid.get(id(batch["tokens"]))
                if rid is not None:
                    self.prefill_end[rid] = time.perf_counter()
                return out
            return wrapped
        self._patch(sched.engine, "prefill_request", prefill)

        def admit(f):
            def wrapped(*a, **kw):
                heap, hdr = f(*a, **kw)
                if hdr is not None:
                    self._sync()
                    self.admitted[int(hdr["req_id"])] = time.perf_counter()
                return heap, hdr
            return wrapped
        self._patch(sched.migrator, "try_admit", admit)

    @staticmethod
    def elapsed_ms(pairs) -> list:
        return [s.elapsed_time(e) for s, e, *_ in pairs]
