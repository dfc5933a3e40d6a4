"""CPU tests of ``perfbench/progtrace.py`` on a hand-built slice and event
list: the rebasing onto the slice's axis, the pairing of spans, the idle
device time inside a span, counter deltas over a window, each reading,
and None from each where the program recorded nothing; then one traced
run of a reduced cell on the CPU through ``perfbench/progrun.py``, where
the program's spans and the profiler's host ranges meet."""
import json
import types

import pytest
import torch

from perfbench import check, progrun, progtrace
from perfbench.test_perfbench_faults import _overrides
from repro_torch.obs.export import validate
from repro_torch.obs.tracer import TraceEvent

T0_NS = 1_700_000_000_000_000_000    # the profiler's trace start
T0 = T0_NS // 1000                   # the same on the program's clock, us


def _slice(union, wall_us=1000.0, host=()):
    return types.SimpleNamespace(_union=[list(u) for u in union],
                                 wall_s=wall_us / 1e6,
                                 host_ranges=list(host))


def _ev(ph, name, ts, tid="pe2", **kw):
    return TraceEvent(ph, name, kw.pop("cat", "engine"), T0 + ts, "pod0",
                      tid, **kw)


def _obs(events, sl=None, window=(0, 1000)):
    obs = {"program_trace": {"events": events, "trace_start_ns": T0_NS,
                             "window_us": (T0 + window[0],
                                           T0 + window[1])}}
    if sl is not None:
        obs["slice"] = sl
    return obs


def test_rebasing_puts_a_program_time_on_the_slice_axis():
    assert progtrace.to_slice_us(T0 + 250, T0_NS) == 250.0
    assert progtrace.to_slice_us(T0 - 3, T0_NS) == -3.0


def test_spans_pair_slices_by_track_and_phases_by_request():
    evs = [_ev("B", "decode", 0), _ev("B", "decode.model", 10),
           _ev("B", "decode", 12, tid="pe3"), _ev("E", "decode", 15,
                                                  tid="pe3"),
           _ev("E", "decode.model", 20), _ev("E", "decode", 30),
           _ev("b", "queued", 5, cat="req", id=7, args={"a": 1}),
           _ev("e", "queued", 40, cat="req", id=7, args={"b": 2}),
           _ev("e", "migrating", 41, cat="req", id=8)]
    got = [(s.name, s.track[1], s.id, s.start - T0, s.end - T0, s.args)
           for s in progtrace.spans(evs)]
    assert got == [("decode", "pe2", None, 0, 30, {}),
                   ("queued", "pe2", 7, 5, 40, {"a": 1, "b": 2}),
                   ("decode.model", "pe2", None, 10, 20, {}),
                   ("decode", "pe3", None, 12, 15, {})]


def test_idle_inside_a_span_is_its_interval_less_the_busy_union():
    sl = _slice([(100, 200), (300, 400)])
    assert progtrace.busy_us(sl, 50, 450) == 200
    assert progtrace.idle_us(sl, 50, 450) == 200
    assert progtrace.idle_us(sl, 150, 350) == 100
    assert progtrace.idle_us(sl, 210, 290) == 80
    evs = [_ev("B", "decode.model", 50), _ev("E", "decode.model", 450),
           _ev("B", "decode.model", 150), _ev("E", "decode.model", 350),
           _ev("B", "decode.model", 500), _ev("E", "decode.model", 700),
           # past the slice's end: left out
           _ev("B", "decode.model", 900), _ev("E", "decode.model", 1100)]
    assert progtrace.decode_model_idle_ms(_obs(evs, sl)) == 0.2


def test_counter_deltas_over_a_window():
    evs = [_ev("C", "heap", t, cat="counter",
               args={"copy_bytes": 100 * k, "store_bytes": k})
           for k, t in ((1, 10), (2, 20), (3, 30))]
    assert progtrace.counter_delta(evs, "heap", "copy_bytes",
                                   T0 + 15, T0 + 35) == 200
    # no sample before the window: from its first inside
    assert progtrace.counter_delta(evs, "heap", "copy_bytes",
                                   T0 + 5, T0 + 25) == 100
    assert progtrace.counter_delta(evs, "heap", "copy_bytes",
                                   T0 + 25, T0 + 28) is None
    assert progtrace.heap_write_amp(_obs(evs, window=(15, 35))) == 101.0


def test_request_phases_count_only_the_window_requests():
    evs = []
    for rid, t in ((1, 100), (2, -50), (3, 200)):
        evs += [_ev("b", "queued", t, cat="req", id=rid, tid="requests"),
                _ev("e", "queued", t + 10 * rid, cat="req", id=rid,
                    tid="requests"),
                _ev("B", "kvx.stage", t + 40, tid="pe0", cat="kvx",
                    args={"rid": rid}),
                _ev("E", "kvx.stage", t + 40 + 100 * rid, tid="pe0",
                    cat="kvx"),
                _ev("b", "migrating", t + 500, cat="req", id=rid,
                    tid="requests"),
                _ev("e", "migrating", t + 500 + 1000 * rid, cat="req",
                    id=rid, tid="requests")]
    obs = _obs(evs, window=(0, 400))
    assert progtrace.window_requests(obs) == {1, 3}
    assert progtrace.req_queued_ms(obs) == 0.02
    assert progtrace.kv_stage_ms(obs) == 0.2
    assert progtrace.kv_wire_ms(obs) == 2.0


def test_idle_by_innermost_span_and_the_clock_gaps():
    sl = _slice([(0, 100), (200, 300), (500, 600), (700, 800)],
                host=[(118, 182, "perfbench.decode_step"),
                      (0, 1000, "perfbench.sched.decode")])
    evs = [_ev("B", "decode", 110), _ev("B", "decode.model", 120),
           _ev("E", "decode.model", 180), _ev("E", "decode", 190),
           _ev("B", "kvx.stage", 550, tid="pe0", cat="kvx"),
           _ev("E", "kvx.stage", 750, tid="pe0", cat="kvx")]
    obs = _obs(evs, sl)
    assert progtrace.idle_by_span(obs) == [["between spans", 0.0002],
                                           ["decode.model", 0.0001],
                                           ["kvx.stage", 0.0001]]
    assert progtrace.clock_gaps_ms(obs) == (0.002, 0.002)
    assert progtrace.span_medians_ms(obs) == {
        "decode": 0.08, "decode.model": 0.06, "kvx.stage": 0.2}


@pytest.mark.parametrize("obs", [
    {}, {"slice": _slice([(0, 10)])},
    _obs([], _slice([(0, 10)])),
    _obs([_ev("i", "stage", 5, cat="kvx")], _slice([(0, 10)]))])
def test_each_reading_is_none_where_the_program_recorded_nothing(obs):
    for name in progrun.READINGS + ("clock_gaps_ms",):
        assert getattr(progtrace, name)(obs) is None, name
    assert progtrace.idle_by_span(obs) == []
    assert progtrace.span_medians_ms(obs) == {}


def test_a_traced_cell_on_the_cpu_reads_the_program(monkeypatch, tmp_path):
    monkeypatch.setattr(check, "CHECK_MIN_TOKENS", 12)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = types.SimpleNamespace(workload="qwen3_4b.long_prompt",
                                     seed=2**31 + 33, seconds=6.0, trace=1)
        r = progrun.traced_cell(
            args, device="cpu", modules_check=False,
            trace_out=str(tmp_path / "t.json"),
            overrides=_overrides("qwen3_4b", "long_prompt"))
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["check"]
    prog = r["program"]
    assert prog["ttft_p50_ms"] > 0 and prog["dropped"] == 0
    for name in progrun.READINGS:
        assert prog[name] is not None and prog[name] > 0, name
    # the slice's ops and the program's spans on one clock: the span and
    # the benchmark's record_function around the same call meet
    start, end = prog["clock_gaps_ms"]
    assert start < 1.0 and end < 1.0
    assert prog["heap_write_amp"] > 1.0 and prog["events_per_step"] > 10
    assert prog["span_medians_ms"]["decode.model"] > 0
    doc = json.loads((tmp_path / "t.json").read_text())
    # requests still in flight at the close leave their phases open
    assert all(e.startswith("unclosed async span") for e in validate(doc))
    assert doc["otherData"]["clock"] == "wall"
    assert len(doc["otherData"]["window_us"]) == 2
