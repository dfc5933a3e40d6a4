"""The port's dry-run (``repro_torch/launch/dryrun.py``) and what it reads
from the configurations: parameter counts, the input and cache stand-ins
and ``model_flops`` against the reference's ``repro/configs/base.py``; the
long_500k skip rule; and, for every reduced configuration and step kind,
the meta record's counts equal to the counts of the same step run on real
CPU tensors.  The reference's ``launch/dryrun.py`` is never imported here:
it sets ``XLA_FLAGS`` to 512 host devices when imported."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as ref_cfg

from repro_torch.configs import base as cfgbase
from repro_torch.launch import dryrun
from repro_torch.models import kvcache, model
from repro_torch.roofline import counter
from repro_torch.train import tree as tree_mod
from _torch_threads import one_intra_op_thread  # noqa: F401

KINDS = ("train", "prefill", "decode")
COUNT_KEYS = ("flops", "bytes", "transcendental", "collective_bytes",
              "collective_by_kind", "n_collective_sites", "by_kernel")


@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
def test_param_count_equals_the_reference(arch):
    rcfg, cfg = ref_cfg.get_config(arch), cfgbase.get_config(arch)
    for active in (False, True):
        assert cfg.param_count(active_only=active) == \
            rcfg.param_count(active_only=active)
    assert cfg.sub_quadratic == rcfg.sub_quadratic


def _ref_leaves(tree):
    return {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {p: (tuple(l.shape), str(l.dtype).removeprefix("torch."))
            for p, l in tree_mod.flatten(tree)}


@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
def test_input_and_cache_specs_equal_the_reference(arch):
    """Every shape's inputs (and the decode cache) as meta tensors of the
    reference's ``ShapeDtypeStruct`` shapes and dtypes, path for path."""
    rcfg, cfg = ref_cfg.get_config(arch), cfgbase.get_config(arch)
    assert list(cfgbase.SHAPES) == list(ref_cfg.SHAPES)
    for name, shape in cfgbase.SHAPES.items():
        assert _same_shape(shape, ref_cfg.SHAPES[name])
        got = cfgbase.input_specs(cfg, shape)
        assert all(t.is_meta for t in tree_mod.leaves(got))
        assert _port_leaves(got) == _ref_leaves(
            ref_cfg.input_specs(rcfg, ref_cfg.SHAPES[name]))
        assert _port_leaves(cfgbase.cache_specs(cfg, 3, 700)) == \
            _ref_leaves(ref_cfg.cache_specs(rcfg, 3, 700))
    assert _port_leaves(cfgbase.frontend_specs(cfg, 2)) == \
        _ref_leaves(ref_cfg.frontend_specs(rcfg, 2))


def _same_shape(a, b):
    return (a.name, a.kind, a.seq_len, a.global_batch) == \
        (b.name, b.kind, b.seq_len, b.global_batch)


def test_cache_struct_matches_init_cache():
    cfg = cfgbase.reduced(cfgbase.get_config("h2o_danube_3_4b"))
    real = kvcache.init_cache(cfg, 2, 80, "cpu")
    meta = kvcache.cache_struct(cfg, 2, 80)
    assert _port_leaves(meta) == _port_leaves(real)
    assert all(t.is_meta for t in tree_mod.leaves(meta))


def test_model_flops_formula():
    """The reference's ``test_model_flops_formula``, on the port."""
    cfg = cfgbase.get_config("arctic_480b")
    tr = cfgbase.SHAPES["train_4k"]
    de = cfgbase.SHAPES["decode_32k"]
    pf = cfgbase.SHAPES["prefill_32k"]
    n = cfg.param_count(active_only=True)
    assert n < cfg.param_count()        # MoE: active < total
    assert dryrun.model_flops(cfg, tr) == pytest.approx(
        6.0 * n * tr.global_batch * tr.seq_len)
    assert dryrun.model_flops(cfg, pf) == pytest.approx(
        2.0 * n * pf.global_batch * pf.seq_len)
    assert dryrun.model_flops(cfg, de) == pytest.approx(
        2.0 * n * de.global_batch)


def test_model_flops_equals_the_reference_for_every_arch_and_shape():
    """The reference's own ``dryrun.model_flops`` for all ten
    configurations and four shapes, computed in a child process (importing
    that module sets ``XLA_FLAGS`` to 512 devices, which must not reach
    this process)."""
    code = ("import json\n"
            "from repro.configs import base\n"
            "from repro.launch import dryrun\n"
            "print(json.dumps({f'{a}/{s}': dryrun.model_flops(\n"
            "    base.get_config(a), base.SHAPES[s])\n"
            "    for a in base.ARCH_NAMES for s in base.SHAPES}))\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src,
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {f"{a}/{s}": dryrun.model_flops(cfgbase.get_config(a), shape)
           for a in cfgbase.ARCH_NAMES
           for s, shape in cfgbase.SHAPES.items()}
    assert got == want


def test_long500k_skip_rule():
    long = cfgbase.SHAPES["long_500k"]
    runs = [a for a in cfgbase.ARCH_NAMES
            if cfgbase.shape_applicable(cfgbase.get_config(a), long)]
    assert sorted(runs) == sorted(
        ["h2o_danube_3_4b", "xlstm_125m", "zamba2_2_7b"])
    rec = dryrun.run_one("qwen3_4b", "long_500k", "card")
    assert rec["status"].startswith("skipped")


def _small(kind):
    return cfgbase.ShapeSpec(f"small_{kind}", kind, 64, 2)


def _counts(summary):
    return {k: summary[k] for k in COUNT_KEYS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", cfgbase.ARCH_NAMES)
def test_meta_record_counts_equal_a_real_cpu_run(arch, kind):
    """The dry-run's record (the step on meta stand-ins) counts exactly
    what the same step counts on real CPU tensors: every kernel charged
    its formula on both routes, every other aten op the same."""
    cfg = cfgbase.reduced(cfgbase.get_config(arch))
    shape = _small(kind)
    rec = dryrun.run_one(arch, shape, "card", cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    fn, args = dryrun.build_step(cfg, shape, device="cpu", seed=3)
    out, real = dryrun.count_step(fn, args)
    assert rec["counted"] == _counts(real)
    assert rec["counted"]["flops"] > 0 and rec["counted"]["bytes"] > 0
    # K2 once a self-attention layer at prefill (a sliding window's is
    # plain, as the reference's)
    k2 = sum(k in ("attn", "shared_attn", "moe", "encdec")
             for k in cfgbase.layer_kinds(cfg))
    if kind != "prefill" or cfg.attention == "swa":
        k2 = 0
    assert rec["counted"]["by_kernel"].get(
        "flash_attention", {"calls": 0})["calls"] == k2
    logits = out[2]["loss"] if kind == "train" else out[0]
    assert bool(torch.isfinite(logits).all())


def test_record_sizes_the_card_and_the_production_meshes():
    """On the card mesh the arguments are whole and the temp is the
    counter's peak; on a production mesh each device holds its shard and
    the temp is null, never a guess."""
    cfg = cfgbase.reduced(cfgbase.get_config("qwen3_4b"))
    shape = cfgbase.ShapeSpec("t", "train", 64, 32)
    memo = {}
    card = dryrun.run_one("qwen3_4b", shape, "card", cfg=cfg, memo=memo)
    pod = dryrun.run_one("qwen3_4b", shape, "pod1", cfg=cfg, memo=memo)
    fn, args = dryrun.build_step(cfg, shape, device="meta")
    whole = sum(t.numel() * t.element_size() for t in tree_mod.leaves(args))
    assert card["memory"]["argument_size_in_bytes"] == whole
    assert card["memory"]["temp_size_in_bytes"] > 0 and card["fits"] is True
    assert pod["memory"]["temp_size_in_bytes"] is None and pod["fits"] is None
    assert whole / 256 <= pod["memory"]["argument_size_in_bytes"] < whole
    assert pod["counted"] == card["counted"] and pod["chips"] == 256
    assert pod["counted_per_device"]["flops"] == card["counted"]["flops"] / 256
    assert "split" in pod["counted_per_device"]
    assert "eager" in card["counted_bytes_are"]
    assert card["model_flops"] == dryrun.model_flops(cfg, shape)
    assert {"hidden", "logits"} <= set(card["constraints"])


def test_full_width_decode_record_on_the_card_mesh():
    """qwen3-4b at its published widths, decode_32k: the arguments are the
    weights and the 128 x 32768-token cache, which do not fit one card."""
    rec = dryrun.run_one("qwen3-4b", "decode_32k", "card")
    assert rec["status"] == "ok"
    cfg = cfgbase.get_config("qwen3_4b")
    cache = sum(t.numel() * t.element_size() for t in tree_mod.leaves(
        cfgbase.cache_specs(cfg, 128, 32768)))
    params = sum(t.numel() * t.element_size() for t in tree_mod.leaves(
        model.init_params(cfg, device="meta")))
    assert rec["memory"]["argument_size_in_bytes"] == params + cache + 128 * 8
    assert rec["fits"] is False
    # decode launches one kernel a layer, decode attention over the cache
    by = rec["counted"]["by_kernel"]
    want = counter.decode_attn_work(128, 32768, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.hd, 2)
    assert set(by) == {"decode_attention"}
    assert by["decode_attention"]["calls"] == cfg.num_layers
    for key in ("flops", "bytes", "transcendental"):
        assert by["decode_attention"][key] == cfg.num_layers * want[key]


def test_cli_writes_its_own_directory(tmp_path, monkeypatch):
    """``main`` writes one record per (arch, shape, mesh) under ``--out``
    (default ``experiments/dryrun_torch``), never ``experiments/dryrun``."""
    monkeypatch.chdir(tmp_path)
    recs = dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--multipod", "both"])
    assert [r["status"] for r in recs] == ["ok", "ok"]
    names = sorted(p.name for p in (tmp_path / "experiments" /
                                    "dryrun_torch").iterdir())
    assert names == ["xlstm-125m.decode_32k.pod1.json",
                     "xlstm-125m.decode_32k.pod2.json"]
    assert not (tmp_path / "experiments" / "dryrun").exists()
    rec = json.loads((tmp_path / "experiments" / "dryrun_torch" /
                      names[1]).read_text())
    assert rec["chips"] == 512
    assert rec["policy"]["small_cache_bytes"] == 1 << 30
    recs = dryrun.main(["--arch", "qwen3_4b", "--shape", "long_500k",
                        "--mesh", "card", "--out", str(tmp_path / "o")])
    assert recs[0]["status"].startswith("skipped")


def test_build_step_runs_on_the_card_unless_told():
    cfg = cfgbase.reduced(cfgbase.get_config("qwen3_4b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.build_step(cfg, _small("decode"))
    fn, args = dryrun.build_step(cfg, _small("decode"), device="meta")
    assert all(t.is_meta for t in tree_mod.leaves(args))
    params = model.init_params(cfg, device="meta")
    assert all(t.is_meta for t in tree_mod.leaves(params))


def test_dp_train_step_charges_its_collectives():
    """The data-parallel step over 4 simulated PEs: its reduce goes through
    K4 (small leaves) and K6 then K5 (large ones), and the record's
    ``collective_by_kind`` sums the ring formulas over those launches."""
    cfg = cfgbase.reduced(cfgbase.get_config("qwen3_4b"))
    shape = cfgbase.ShapeSpec("t", "train", 32, 8)
    rec = dryrun.run_one("qwen3_4b", shape, "card", cfg=cfg, comms_npes=4)
    fn, args = dryrun.build_step(cfg, shape, device="cpu", comms_npes=4)
    _, real = dryrun.count_step(fn, args)
    assert rec["counted"] == _counts(real)
    kinds = rec["counted"]["collective_by_kind"]
    by = rec["counted"]["by_kernel"]
    assert set(kinds) == {"collective-permute", "reduce-scatter",
                          "all-gather"}
    assert by["ring_reduce_scatter"]["calls"] == \
        by["ring_allgather"]["calls"] > 0
    assert kinds["all-gather"] == by["ring_allgather"]["collective_bytes"]
    assert rec["counted"]["n_collective_sites"] == sum(
        by[k]["calls"] for k in ("remote_put", "ring_reduce_scatter",
                                 "ring_allgather"))
    assert np.isclose(rec["counted"]["collective_bytes"], sum(kinds.values()))
