"""Faults planted under a serving cell's timed path, one for each fault the
cell can have: a token altered where it is produced, a step that leaves
its state unchanged (decode's K/V store into the pool dropped), and the
exchange between PEs left out (the migration's block payloads arrive as
zeros).  Each is a context manager that patches the program while it is
open.  ``perfbench/control.py --faults`` reads them on the card at a
cell's own size; ``test_perfbench_faults.py`` at a reduced size on the
CPU.  The benchmark's own runs never plant one.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch


def token_altered():
    """Every sampled batch's first token moved to the next id: every
    prefill's token, and slot 0's at each decode step."""
    from repro_torch.serve.engine import Engine
    orig = Engine._sample

    def altered(self, logits, gen, temperature):
        tok = orig(self, logits, gen, temperature).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    return mock.patch.object(Engine, "_sample", altered)


def state_unchanged():
    """Decode's K/V store is dropped: the pool keeps the state it had."""
    from repro_torch.serve.paged_attn import PagedDecodeView
    return mock.patch.object(PagedDecodeView, "writeback",
                             lambda self, ctx, heap, *a: heap)


def exchange_left_out():
    """The migration's block payloads arrive as zeros."""
    from repro_torch.core import rma, signal
    from repro_torch.serve.kvxfer import KVMigrator
    orig_send = KVMigrator._send_runs
    put_nbi, put_sig = rma.put_nbi, signal.put_signal_nbi

    def zero_put(ctx, heap, dest, value, *a, **kw):
        return put_nbi(ctx, heap, dest, torch.zeros_like(value), *a, **kw)

    def zero_sig(ctx, heap, dest, value, *a, **kw):
        return put_sig(ctx, heap, dest, torch.zeros_like(value), *a, **kw)

    def send(self, heap, ids, sig, dst_pe):
        with mock.patch.object(rma, "put_nbi", zero_put), \
                mock.patch.object(signal, "put_signal_nbi", zero_sig):
            return orig_send(self, heap, ids, sig, dst_pe)
    return mock.patch.object(KVMigrator, "_send_runs", send)


FAULTS = {f.__name__: f for f in (token_altered, state_unchanged,
                                  exchange_left_out)}


@contextlib.contextmanager
def planted(name: str):
    with FAULTS[name]():
        yield
