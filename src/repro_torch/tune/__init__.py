"""Online autotuning subsystem (paper §IV: "tuned" transport selection).

Counterpart of ``repro/tune/__init__.py``.

Four modules that turn the static analytic cost model in ``core.cutover``
into the paper's *measured* adaptive behaviour:

- ``telemetry``  — pluggable per-(op, path, tier, work_items) sample sink
                   that replaces the flat context ledger (bounded memory);
- ``estimator``  — least-squares fits of effective alpha/bandwidth per
                   transport path from observed (nbytes, t_sec) samples,
                   and measured cutover tables derived from the fits;
- ``table``      — JSON-persistable :class:`TuningTable` (save/load/merge)
                   so one profiling run warm-starts later sessions;
- ``env``        — the ``ISHMEM_*`` environment-variable configuration
                   surface mirroring the real Intel SHMEM library.

Typical workflow::

    sink  = telemetry.TelemetrySink()          # or ctx.telemetry after a run
    ...                                        # run ops / a profiling sweep
    tbl   = estimator.build_table(sink)        # fit measured cutovers
    tbl.save("BENCH_cutover.json")             # persist
    # later session:
    #   ISHMEM_TUNING_FILE=BENCH_cutover.json  -> context.init arms the table
"""
from repro_torch.tune import env, estimator, table, telemetry  # noqa: F401

__all__ = ["env", "estimator", "table", "telemetry"]
