"""Lock-free reverse-offload ring buffer (paper §III-D).

A copy of ``repro/core/ring.py`` (pure Python, no array library): the
port keeps its own so that it imports nothing of the JAX package.

Faithful protocol model of the GPU->CPU request ring:

  - fixed 64-byte messages;
  - transmit-slot allocation by a single atomic fetch-and-increment, arbitrating
    any number of producer threads;
  - slot readiness signaled by a per-slot *lap tag* (store-only, fire-and-forget:
    the producer stores payload, then stores tag = lap+1; the consumer polls the
    tag — no producer-side progress thread);
  - reverse flow control OFF the critical path: the consumer republishes its
    consumed count only every ``publish_every`` messages; producers spin only
    when the ring looks full against that (stale) count;
  - completions are allocated independently, permitting out-of-order replies.

The class is a *step machine*: every micro-step (reserve / write / tag /
consume / publish) is an explicit method, so property tests can interleave
thousands of schedules and assert exactly-once delivery and no-overwrite.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

MSG_BYTES = 64
HEADER_BYTES = 8
PAYLOAD_BYTES = MSG_BYTES - HEADER_BYTES

# producer micro-states
IDLE, RESERVED, WRITTEN, TAGGED = range(4)


@dataclasses.dataclass
class Message:
    op: str
    payload: bytes = b""

    def __post_init__(self):
        if len(self.payload) > PAYLOAD_BYTES:
            raise ValueError("message exceeds the fixed 64-byte format")


class RingBuffer:
    def __init__(self, slots: int = 128, publish_every: int = 16):
        assert slots > 0 and (slots & (slots - 1)) == 0, "power-of-two ring"
        self.slots = slots
        self.publish_every = publish_every
        # shared memory (what would live in host-visible memory)
        self.write_reserve = 0            # atomic fetch-inc counter
        self.consumed_published = 0       # consumer's (lazily) published count
        self.slot_tag = [0] * slots       # lap tags (0 = never written)
        self.slot_data: list = [None] * slots
        self.completions: dict = {}       # msg index -> result (out of order)
        # consumer private state
        self.read_index = 0
        self._since_publish = 0
        # producers' private state: pid -> (state, idx, msg)
        self._prod: dict = {}
        # instrumentation
        self.delivered: list = []
        self.spin_count = 0
        self.store_ops = 0                # bus stores (fire-and-forget)
        self.publish_ops = 0
        self.overwrite_errors = 0

    # ------------------------------------------------------------ producers
    def start(self, pid, msg: Message):
        assert self._prod.get(pid, (IDLE,))[0] == IDLE, "one msg at a time"
        self._prod[pid] = (IDLE, None, msg)

    def producer_step(self, pid) -> Optional[int]:
        """Advance producer ``pid`` one micro-step.  Returns the message index
        once the message becomes visible (TAGGED), else None."""
        if pid not in self._prod:
            return None
        state, idx, msg = self._prod[pid]
        if state == IDLE:
            # flow control against the *published* (possibly stale) count —
            # never in the critical path unless the ring looks full
            if self.write_reserve - self.consumed_published >= self.slots:
                self.spin_count += 1
                return None
            idx = self.write_reserve
            self.write_reserve += 1       # single atomic fetch-and-increment
            self._prod[pid] = (RESERVED, idx, msg)
            return None
        if state == RESERVED:
            slot = idx % self.slots
            lap = idx // self.slots
            # the no-overwrite invariant: the previous occupant must have been
            # consumed.  Flow control guarantees this; check it explicitly.
            if self.slot_tag[slot] > lap:
                self.overwrite_errors += 1
            self.slot_data[slot] = (idx, msg)
            self.store_ops += 1           # payload store (one bus op: 64 B)
            self._prod[pid] = (WRITTEN, idx, msg)
            return None
        if state == WRITTEN:
            slot = idx % self.slots
            self.slot_tag[slot] = idx // self.slots + 1   # release store
            self.store_ops += 1
            self._prod[pid] = (TAGGED, idx, msg)
            return idx
        return None                        # TAGGED: waiting for completion

    def producer_done(self, pid) -> bool:
        state, idx, _ = self._prod.get(pid, (IDLE, None, None))
        if state == TAGGED and idx in self.completions:
            del self._prod[pid]
            return True
        return False

    # ------------------------------------------------------------- consumer
    def consumer_step(self, executor=None) -> Optional[int]:
        """Process one ready message (single consumer thread).  Returns the
        consumed message index or None if the head slot isn't ready."""
        idx = self.read_index
        slot = idx % self.slots
        if self.slot_tag[slot] != idx // self.slots + 1:
            return None                   # head not ready yet
        stored_idx, msg = self.slot_data[slot]
        assert stored_idx == idx, "ring ordering violated"
        result = executor(msg) if executor else None
        self.delivered.append((idx, msg))
        self.completions[idx] = result    # independently allocated, OOO replies
        self.read_index += 1
        self._since_publish += 1
        if self._since_publish >= self.publish_every:
            self.publish()
        return idx

    def publish(self):
        """Publish the consumed count (reverse flow control, off critical path)."""
        self.consumed_published = self.read_index
        self._since_publish = 0
        self.publish_ops += 1

    # -------------------------------------------------------------- metrics
    def flow_control_overhead(self) -> float:
        total = self.store_ops + self.publish_ops
        return self.publish_ops / total if total else 0.0
