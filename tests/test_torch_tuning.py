"""The port's tuning knobs (``tune/*.py``, ``core/cutover.py``'s learned
table, ``context.init``'s ``ISHMEM_*`` parsing, ``fit_tuning_table``) held
to the JAX package's on the same inputs.

Everything here is host arithmetic, so the comparisons are exact: sink
buckets, size histograms, reservoirs (with their decimation strides) and
provenance streams; the estimator's fits; ``choose_path`` and
``choose_collective_path`` over a (tier, work_items, nbytes) grid under
each precedence level; the environment parser on the same dicts; tables
saved by either package and loaded by the other.  The laws of
``tests/test_tuning.py`` that need no benchmark are run on the port.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.core import context as ref_context, cutover as ref_cutover
from repro.tune import env as ref_env, estimator as ref_estimator, \
    table as ref_table, telemetry as ref_telemetry
from repro_torch.core import collectives, context, cutover, device, heap
from repro_torch.tune import env as env_mod, estimator, table as table_mod, \
    telemetry
from _torch_threads import one_intra_op_thread  # noqa: F401

HW = cutover.HwParams()
WORK_ITEMS = (1, 16, 128, 1024)
TIERS = ("local", "ici", "dcn")
OPS = ("put", "get", "put_nbi(pending)", "fcollect", "psum", "stage")
PATHS = ("direct", "engine", "proxy")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    """A stray ``ISHMEM_*`` variable must not change what these check."""
    import os
    for name in list(os.environ):
        if name.startswith("ISHMEM_"):
            monkeypatch.delenv(name)


def _records(seed, n, *, sources=("model",)):
    """One random op stream as plain tuples, fed alike to both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((OPS[rng.integers(len(OPS))], int(rng.integers(0, 1 << 22)),
                    PATHS[rng.integers(3)], TIERS[rng.integers(3)],
                    float(rng.random() * 1e-4),
                    int(WORK_ITEMS[rng.integers(len(WORK_ITEMS))]),
                    sources[rng.integers(len(sources))]))
    return out


def _fill(tel, recs, **kw):
    sink = tel.TelemetrySink(**kw)
    for r in recs:
        sink.record(tel.OpRecord(*r))
    return sink


def _state(sink):
    """Everything a sink holds, as plain values."""
    return {
        "trace": [dataclasses.astuple(r) for r in sink.trace],
        "sources": {
            src: {k: (b.count, b.bytes_total, b.time_total, b.t_min,
                      b.t_max, dict(b.size_hist), list(b.samples),
                      b.max_samples, b._stride, b._seen)
                  for k, b in buckets.items()}
            for src, buckets in sink.sources.items()},
        "snapshot": sink.snapshot(),
        "total_time": sink.total_time(),
        "total_count": sink.total_count(),
        "wallclock_time": sink.source_time("wallclock"),
        "nsamples": (sink.nsamples(), sink.nsamples("wallclock")),
        "tiers": sink.tiers(),
    }


# ---------------------------------------------------------------------------
# telemetry: exact against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,max_trace,max_samples", [
    (0, 400, 65536, 256), (1, 3000, 100, 16), (2, 2000, 64, 8)])
def test_sink_exact_against_reference(seed, n, max_trace, max_samples):
    """Buckets, log2 histograms, reservoirs and their decimation, the
    bounded trace (pending markers kept), per-source maps and the
    snapshot: bitwise the reference's."""
    recs = _records(seed, n, sources=("model", "wallclock", "model"))
    kw = dict(max_trace=max_trace, max_samples_per_bucket=max_samples)
    ref, port = _fill(ref_telemetry, recs, **kw), _fill(telemetry, recs, **kw)
    assert _state(port) == _state(ref)
    for path, tier in (("direct", "ici"), ("engine", "local")):
        for src in (None, "wallclock"):
            assert port.samples(path=path, tier=tier, source=src) == \
                ref.samples(path=path, tier=tier, source=src)
            assert port.work_item_keys(path=path, tier=tier, source=src) == \
                ref.work_item_keys(path=path, tier=tier, source=src)


def test_sink_merge_exact_against_reference():
    a_recs = _records(3, 900, sources=("model", "wallclock"))
    b_recs = _records(4, 700, sources=("model", "wallclock"))
    kw = dict(max_samples_per_bucket=32)
    ra, rb = _fill(ref_telemetry, a_recs, **kw), _fill(ref_telemetry, b_recs,
                                                       **kw)
    pa, pb = _fill(telemetry, a_recs, **kw), _fill(telemetry, b_recs, **kw)
    ra.merge(rb)
    pa.merge(pb)
    assert _state(pa) == _state(ra)
    # replay rebuilds the same aggregates in both
    assert _state(telemetry.replay(pa.trace)) == \
        _state(ref_telemetry.replay(ra.trace))


def test_null_sink_and_context_record_sources():
    a, b = telemetry.NullSink(), telemetry.NullSink()
    a.buckets[("put", "direct", "ici", 1)] = telemetry.StatBucket()
    a.trace.append(telemetry.OpRecord("put", 64, "direct", "ici", 1e-6))
    assert b.buckets == {} and b.trace == []
    assert a.total_time() == 0.0 and a.source_time("wallclock") == 0.0
    ctx, _ = context.init(npes=4, node_size=2, device="cpu")
    rctx, _ = ref_context.init(npes=4, node_size=2)
    for c in (ctx, rctx):
        c.record("put", 4096, "direct", "ici", 16)
        c.record("serve_decode", 512, "engine", "local", 2, t_sec=3e-3,
                 source="wallclock")
    assert _state(ctx.telemetry) == _state(rctx.telemetry)
    assert ctx.ledger[-1].op == "put"          # wall clock stays off the trace
    ctx.reset_ledger()
    assert not ctx.ledger and not ctx.telemetry.buckets


# ---------------------------------------------------------------------------
# estimator: exact fits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_estimator_fits_exact_against_reference(noise):
    kw = dict(work_items=WORK_ITEMS, noise=noise, tiers=("local", "ici",
                                                          "dcn"))
    rsink = ref_estimator.synthetic_sweep(ref_cutover.HwParams(), **kw)
    psink = estimator.synthetic_sweep(HW, **kw)
    assert _state(psink) == _state(rsink)
    # collective samples are ignored by both fits
    for lb in range(7, 25, 3):
        t = cutover.t_collective("fcollect", 1 << lb, 8, work_items=128,
                                 path="direct", hw=HW)
        for tel, sink in ((ref_telemetry, rsink), (telemetry, psink)):
            sink.record(tel.OpRecord("fcollect", 1 << lb, "direct", "ici",
                                     t, 128))
    ptbl, rtbl = estimator.build_table(psink), ref_estimator.build_table(rsink)
    assert ptbl.to_json() == rtbl.to_json()
    assert estimator.agreement(ptbl, HW, work_items=WORK_ITEMS) == \
        ref_estimator.agreement(rtbl, ref_cutover.HwParams(),
                                work_items=WORK_ITEMS) >= 0.95
    d = ptbl.profiles[("direct", "ici", 128)]
    assert d.bw == pytest.approx(cutover.direct_bw(HW, 128), rel=0.10)
    for samples in ([(64, 1e-6)], [(64, 1e-6)] * 5,
                    [(1 << b, 2e-6) for b in range(6, 12)],
                    [(int(x), float(x) * 1e-9 + 1e-6) for x in
                     np.random.default_rng(5).integers(1, 1 << 20, 40)]):
        p, r = estimator.fit_linear(samples), ref_estimator.fit_linear(samples)
        assert (p is None and r is None) or \
            dataclasses.asdict(p) == dataclasses.asdict(r)


def test_estimator_wallclock_stream_only():
    recs = _records(6, 1500, sources=("model", "wallclock"))
    rsink, psink = _fill(ref_telemetry, recs), _fill(telemetry, recs)
    for src in ("wallclock", None):
        p = estimator.build_table(psink, source=src or "measured",
                                  sample_source=src)
        r = ref_estimator.build_table(rsink, source=src or "measured",
                                      sample_source=src)
        assert p.to_json() == r.to_json()
        assert p.source == (src or "measured")


# ---------------------------------------------------------------------------
# choose_path / choose_collective_path over a grid
# ---------------------------------------------------------------------------


def _grid_tunings(tmp_path):
    """(port Tuning, reference Tuning) pairs at every precedence level."""
    rsink = ref_estimator.synthetic_sweep(ref_cutover.HwParams(),
                                          work_items=(1, 128), noise=0.03)
    path = tmp_path / "t.json"
    ref_estimator.build_table(rsink).save(str(path))
    ptbl, rtbl = table_mod.TuningTable.load(str(path)), \
        ref_table.TuningTable.load(str(path))
    skew = {("ici", 16): 1 << 12, ("local", 1024): 1 << 26}
    return [
        (cutover.Tuning(), ref_cutover.Tuning()),
        (cutover.Tuning(table=ptbl), ref_cutover.Tuning(table=rtbl)),
        (cutover.Tuning(table=table_mod.TuningTable(cutovers=skew)),
         ref_cutover.Tuning(table=ref_table.TuningTable(cutovers=skew))),
        (cutover.Tuning(cutover_bytes=1 << 16, table=ptbl),
         ref_cutover.Tuning(cutover_bytes=1 << 16, table=rtbl)),
        (cutover.Tuning(force_path="engine", table=ptbl),
         ref_cutover.Tuning(force_path="engine", table=rtbl)),
        (cutover.Tuning(work_group_size=32, table=ptbl),
         ref_cutover.Tuning(work_group_size=32, table=rtbl)),
    ]


def test_choose_path_grid_exact(tmp_path):
    hw, rhw = HW, ref_cutover.HwParams()
    n = 0
    for pt, rt in _grid_tunings(tmp_path):
        for tier in TIERS:
            for wi in (None, 1, 8, 128, 512):
                for lb in range(0, 31, 2):
                    nbytes = 1 << lb
                    assert cutover.choose_path(
                        nbytes, work_items=wi, tier=tier, hw=hw,
                        tuning=pt) == ref_cutover.choose_path(
                        nbytes, work_items=wi, tier=tier, hw=rhw, tuning=rt)
                    for kind, npes in (("fcollect", 4), ("broadcast", 8),
                                       ("alltoall", 2)):
                        assert cutover.choose_collective_path(
                            kind, nbytes, npes, work_items=wi, tier=tier,
                            hw=hw, tuning=pt) == \
                            ref_cutover.choose_collective_path(
                                kind, nbytes, npes, work_items=wi, tier=tier,
                                hw=rhw, tuning=rt)
                    n += 1
    assert n == 6 * 3 * 5 * 16


def test_learned_table_flips_and_uncovered_tiers_fall_back():
    tbl = table_mod.TuningTable(cutovers={("ici", 1): 1 << 30})
    armed = cutover.Tuning(table=tbl)
    n = 1 << 20
    assert cutover.choose_path(n, work_items=1, tier="ici", hw=HW) == "engine"
    assert cutover.choose_path(n, work_items=1, tier="ici", hw=HW,
                               tuning=armed) == "direct"
    assert cutover.choose_path(n, work_items=1, tier="local", hw=HW,
                               tuning=armed) == \
        cutover.choose_path(n, work_items=1, tier="local", hw=HW)
    ctx, _ = context.init(npes=2, node_size=2, tuning=cutover.Tuning(),
                          device="cpu")
    want = collectives._path(ctx, "alltoall", 8192, 2, 1)
    ctx.tuning = cutover.Tuning(table=table_mod.TuningTable(
        cutovers={("local", 1): 123}))
    assert collectives._path(ctx, "alltoall", 8192, 2, 1) == want


# ---------------------------------------------------------------------------
# tables across the two packages
# ---------------------------------------------------------------------------


def test_tables_round_trip_across_packages(tmp_path):
    rtbl = ref_estimator.build_table(ref_estimator.synthetic_sweep(
        ref_cutover.HwParams(), work_items=WORK_ITEMS, noise=0.02))
    ptbl = estimator.build_table(estimator.synthetic_sweep(
        HW, work_items=WORK_ITEMS, noise=0.02))
    rtbl.save(str(tmp_path / "ref.json"))
    ptbl.save(str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    back = table_mod.TuningTable.load(str(tmp_path / "ref.json"))
    rback = ref_table.TuningTable.load(str(tmp_path / "port.json"))
    assert back.to_json() == rtbl.to_json() == rback.to_json()
    assert any(v is None for v in back.to_json()["cutovers"].values())
    # merge, lookup and nearest work-group size agree
    other = {"profiles": {"direct/ici/1": {"alpha": 3e-6, "bw": 3e9,
                                           "nsamples": 30, "resid": 0.0,
                                           "source": "wallclock"}},
             "cutovers": {"ici/16": 2000}, "source": "w", "version": 2}
    pm = back.merge(table_mod.TuningTable.from_json(other))
    rm = rtbl.merge(ref_table.TuningTable.from_json(other))
    assert pm.to_json() == rm.to_json()
    for wi in (1, 2, 3, 100, 512, 4096):
        assert pm.lookup("ici", wi) == rm.lookup("ici", wi)
    assert pm.lookup("dcn", 1) is None
    assert "wallclock" in pm.profiles[("direct", "ici", 1)].source


# ---------------------------------------------------------------------------
# the ISHMEM_* environment surface
# ---------------------------------------------------------------------------


ENVS = [
    {},
    {"ISHMEM_ENABLE_CUTOVER": "1", "ISHMEM_CUTOVER_BYTES": "16K",
     "ISHMEM_FORCE_PATH": "engine", "ISHMEM_WORK_GROUP_SIZE": "256"},
    {"ISHMEM_ENABLE_CUTOVER": "0"},
    {"ISHMEM_ENABLE_CUTOVER": "off", "ISHMEM_FORCE_PATH": "Engine"},
    {"ISHMEM_CUTOVER_BYTES": "2M", "ISHMEM_NBI_COALESCE": "0"},
    {"ISHMEM_CUTOVER_BYTES": "1.5G", "ISHMEM_WORK_GROUP_SIZE": "64"},
    {"ISHMEM_CUTOVER_BYTES": " 4096 ", "ISHMEM_NBI_COALESCE": "yes"},
    {"ISHMEM_FORCE_PATH": "warp"},
    {"ISHMEM_ENABLE_CUTOVER": "maybe"},
    {"ISHMEM_CUTOVER_BYTES": "lots"},
    {"ISHMEM_WORK_GROUP_SIZE": "wide"},
    {"ISHMEM_FORCE_PATH": ""},
]


@pytest.mark.parametrize("environ", ENVS)
def test_env_parsing_exact(environ):
    try:
        want = ref_env.load_env(environ)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            env_mod.load_env(environ)
        assert str(got.value) == str(e)
        return
    got = env_mod.load_env(environ)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    pt, rt = env_mod.tuning_from_env(environ), ref_env.tuning_from_env(environ)
    assert dataclasses.asdict(pt) == dataclasses.asdict(rt)
    # FORCE > CUTOVER_BYTES > table > model, and a disabled cutover keeps
    # the dcn tier on the proxy
    for tier in TIERS:
        for nbytes in (64, 1 << 20, 1 << 26):
            assert cutover.choose_path(nbytes, tier=tier, tuning=pt) == \
                ref_cutover.choose_path(nbytes, tier=tier, tuning=rt)
    assert env_mod.parse_bytes("2M") == ref_env.parse_bytes("2M") == 2 << 20


def test_init_reads_the_environment(tmp_path, monkeypatch):
    tbl = estimator.build_table(estimator.synthetic_sweep(
        HW, work_items=WORK_ITEMS))
    path = tmp_path / "warm.json"
    tbl.save(str(path))
    monkeypatch.setenv("ISHMEM_TUNING_FILE", str(path))
    monkeypatch.setenv("ISHMEM_WORK_GROUP_SIZE", "64")
    monkeypatch.setenv("ISHMEM_NBI_COALESCE", "0")
    ctx, _ = context.init(npes=2, device="cpu")
    rctx, _ = ref_context.init(npes=2)
    assert ctx.tuning.work_group_size == rctx.tuning.work_group_size == 64
    assert ctx.tuning.nbi_coalesce is rctx.tuning.nbi_coalesce is False
    assert ctx.tuning.table.to_json() == rctx.tuning.table.to_json() == \
        tbl.to_json()
    monkeypatch.setenv("ISHMEM_TUNING_FILE", str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError):
        context.init(npes=2, device="cpu")
    # an explicit tuning wins over the environment
    ctx, _ = context.init(npes=2, device="cpu", tuning=cutover.Tuning())
    assert ctx.tuning == cutover.Tuning()


def test_fit_tuning_table_online_and_null_sink():
    ctx, _ = context.init(npes=4, node_size=4, tuning=cutover.Tuning(),
                          device="cpu")
    rctx, _ = ref_context.init(npes=4, node_size=4,
                               tuning=ref_cutover.Tuning())
    estimator.synthetic_sweep(ctx.hw, sink=ctx.telemetry)
    ref_estimator.synthetic_sweep(rctx.hw, sink=rctx.telemetry)
    tbl, rtbl = ctx.fit_tuning_table(), rctx.fit_tuning_table()
    assert ctx.tuning.table is tbl and tbl.to_json() == rtbl.to_json()
    none = ctx.fit_tuning_table(sample_source="wallclock")
    assert none.to_json() == rctx.fit_tuning_table(
        sample_source="wallclock").to_json()
    assert ctx.tuning.table is tbl             # an empty fit arms nothing
    nctx, _ = context.init(npes=2, device="cpu",
                           telemetry=telemetry.NullSink())
    assert nctx.fit_tuning_table().source == "empty"


def test_work_group_size_feeds_device_cutovers(monkeypatch):
    """``ISHMEM_WORK_GROUP_SIZE`` and explicit widths reach the device ops'
    records, and a sweep at two widths fits per-width cutovers, as
    ``tests/test_device.py::test_device_put_feeds_work_group_resolved_
    cutovers`` holds for the reference."""
    monkeypatch.setenv("ISHMEM_WORK_GROUP_SIZE", "32")
    ctx, hp = context.init(npes=4, node_size=4, heap_words=1 << 22,
                           device="cpu")
    assert device.work_group(ctx, pe=0).size == 32
    buf = hp.malloc((1 << 21,), torch.float32)
    for wgs in (32, 512):
        wg = device.work_group(ctx, size=wgs, pe=0)
        for lb in range(7, 24, 2):
            n = 1 << lb
            view = heap.SymPtr("float32", buf.offset, (n // 4,))
            hp = device.put(wg, hp, view, torch.zeros(n // 4), 1)
    tbl = ctx.fit_tuning_table(arm=True)
    assert ("ici", 32) in tbl.cutovers and ("ici", 512) in tbl.cutovers
    assert ctx.tuning.table is tbl
    assert math.isfinite(tbl.profiles[("direct", "ici", 32)].alpha)


def test_bounded_trace_and_reservoir_laws():
    sink = telemetry.TelemetrySink(max_trace=128, max_samples_per_bucket=32)
    for i in range(10_000):
        sink.record(telemetry.OpRecord("put", i + 1, "direct", "ici",
                                       1e-6 * (i + 1), 1))
    b = sink.buckets[("put", "direct", "ici", 1)]
    assert len(sink.trace) <= 128 and len(b.samples) <= 32
    assert b.count == 10_000
    xs = [x for x, _ in b.samples]
    assert min(xs) < 2_000 and max(xs) > 8_000
    flood = telemetry.TelemetrySink(max_trace=64)
    for _ in range(1000):
        flood.record(telemetry.OpRecord("put_nbi(pending)", 64, "engine",
                                        "ici", 1e-6, 1))
    assert len(flood.trace) <= 64
    json.dumps(sink.snapshot())
