"""The port stands alone: no JAX, nothing of the JAX package, and entry
points that run on the card unless told otherwise."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import _bridge, _devices
from repro_torch.configs import base
from repro_torch.core import context, device, heap as heap_mod
from repro_torch.core.api import Ishmem
from repro_torch.kernels import ops as kernel_ops, ring_collectives
from repro_torch.launch import serve as launch_serve, shmem_collectives
from repro_torch.models import model
from repro_torch.serve.engine import Engine
from _torch_threads import one_intra_op_thread  # noqa: F401

MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))


# the tuning knobs and the observability bundle: the reference's
# jax-free tune/ and obs/ modules, each kept as the port's own copy
SLICE_9 = ("tune.table", "tune.telemetry", "tune.env", "tune.estimator",
           "tune", "obs.env", "obs.prof", "obs.metrics", "obs.critical",
           "obs.calibrate", "obs.refit", "obs.recorder", "obs.alerts",
           "obs.audit", "obs", "obs.analyze")


def test_every_module_imports_without_jax_or_the_reference():
    assert len(MODULES) > 20
    assert {"repro_torch.obs.tracer", "repro_torch.obs.export"} <= \
        set(MODULES)
    assert len(SLICE_9) == 16
    assert {f"repro_torch.{m}" for m in SLICE_9} <= set(MODULES) | \
        {"repro_torch.tune", "repro_torch.obs"}
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_port_sources_name_no_jax_import():
    root = Path(repro_torch.__file__).resolve().parent
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1]
                assert not (mod == "jax" or mod.startswith("jax.")
                            or mod == "repro" or mod.startswith("repro.")), \
                    f"{path}: {line}"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")


def test_device_defaults_to_cuda_and_raises_without_it(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        _devices.resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        _devices.resolve("cuda")
    assert _devices.resolve("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda_unless_cpu(no_card):
    cfg = base.reduced(base.get_config("qwen3-4b"))
    with pytest.raises(RuntimeError):
        context.init(npes=2)
    with pytest.raises(RuntimeError):
        heap_mod.create(2)
    with pytest.raises(RuntimeError):
        model.init_params(cfg)
    params = model.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        Engine(cfg, params, max_len=8)
    with pytest.raises(RuntimeError):
        launch_serve.main(["--disagg", "--requests", "1"])
    with pytest.raises(RuntimeError):
        launch_serve.main(["--disagg", "--fused-attn", "--requests", "1"])
    with pytest.raises(RuntimeError):
        launch_serve.seq_parallel_report(2, prompt_len=16)
    ctx, heap = context.init(npes=2, device="cpu")
    assert heap.device == torch.device("cpu")
    assert Engine(cfg, params, max_len=8, device="cpu").device.type == "cpu"


def test_device_layer_entry_points_raise_without_cuda_unless_cpu(no_card):
    """The work-group layer runs on a heap, which lives on the card unless
    the caller asks for the CPU; the new launcher flags take --device."""
    with pytest.raises(RuntimeError):
        launch_serve.main(["--seq-parallel", "2", "--batch", "1",
                           "--prompt-len", "8", "--max-new", "1"])
    ctx, heap = context.init(npes=2, device="cpu")
    wg = device.work_group(ctx, pe=0)
    buf = heap.malloc((128,), "float32")
    heap = device.put(wg, heap, buf, torch.ones(128), 1)
    assert device.get(wg, heap, buf, 1).device == torch.device("cpu")
    rows = torch.ones(3, 128)
    assert kernel_ops.reduce_tile(rows).tolist() == [3.0] * 128
    rep = launch_serve.seq_parallel_report(2, prompt_len=16, device="cpu")
    assert rep["partials"] == 3 and rep["max_abs_err"] < 5e-5
    sched = launch_serve.main(["--disagg", "--fused-attn", "--device", "cpu",
                               "--requests", "2", "--prompt-len", "8",
                               "--max-new", "2"])
    assert sched.fused_attn and sched.heap.device == torch.device("cpu")


def test_collectives_entry_points_raise_without_cuda_unless_cpu(no_card):
    with pytest.raises(RuntimeError):
        Ishmem(npes=2)
    with pytest.raises(RuntimeError):
        ring_collectives.barrier_push(2)
    with pytest.raises(RuntimeError):
        shmem_collectives.main(["--npes", "2"])
    assert Ishmem(npes=2, device="cpu").heap.device == torch.device("cpu")
    assert ring_collectives.barrier_push(2, device="cpu").tolist() == [1, 1]


def test_engine_refuses_params_on_another_device():
    cfg = base.reduced(base.get_config("qwen3-4b"))
    params = model.init_params(cfg, device="cpu")
    with pytest.raises(ValueError):
        Engine(cfg, params, max_len=8, device="meta")


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_bridge_copies_exactly(dtype):
    import jax.numpy as jnp
    a = np.asarray(jnp.asarray(np.arange(-6, 6, dtype=np.float32) * 1.5)
                   .astype(dtype))
    assert not a.flags.writeable               # JAX hands out read-only views
    tree = _bridge.to_torch({"blocks": [{"w": a[None]}], "x": a}, "cpu")
    t = tree["x"]
    assert str(t.dtype).removeprefix("torch.") == dtype
    assert tree["blocks"][0]["w"].shape == (1, 12)
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    t += 1                                     # a copy, not the JAX buffer
    np.testing.assert_array_equal(tree["blocks"][0]["w"][0].float().numpy(),
                                  a.astype(np.float32))


def test_training_entry_points_raise_without_cuda_unless_cpu(no_card, tmp_path):
    """The launcher, the loop, ``init_state`` and the token stream run on
    the card unless they get ``device="cpu"``."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train import train_step, trainer
    cfg = base.reduced(base.get_config("qwen3-4b"))
    dcfg = pipeline.DataConfig(cfg.vocab_size, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1", "--comms-backend", "shmem"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train(cfg, trainer.TrainConfig(steps=1, seq_len=8,
                                               global_batch=2),
                      log_fn=lambda *_: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_step.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.TokenStream(dcfg)
    assert pipeline.TokenStream(dcfg, device="cpu").batch(0)[
        "tokens"].device == torch.device("cpu")
    params, opt_state = train_step.init_state(cfg, device="cpu")
    assert params["embed"].device == torch.device("cpu")
    _, _, hist = launch_train.main(
        ["--device", "cpu", "--steps", "1", "--seq-len", "8",
         "--global-batch", "2", "--ckpt-dir", str(tmp_path)],
        log_fn=lambda *_: None)
    assert len(hist) == 1


def test_fleet_entry_points_raise_without_cuda_unless_cpu(no_card):
    """The fleet, the host proxy's context, ``--fleet`` (with and without
    ``--chaos``) and ``--cross-pod`` run on the card unless told
    ``--device cpu``; the new modules import neither JAX nor the JAX
    package (the module walk above covers them)."""
    from repro_torch.core.proxy import HostProxy
    from repro_torch.serve.frontend import Fleet, FleetConfig
    assert {"repro_torch.core.proxy", "repro_torch.core.ring",
            "repro_torch.serve.fault", "repro_torch.serve.recovery",
            "repro_torch.serve.frontend.fleet"} <= set(MODULES)
    with pytest.raises(RuntimeError, match="CUDA"):
        Fleet(FleetConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        HostProxy(context.init(npes=2, node_size=1)[0])
    small = ["--prompt-len", "8", "--max-new", "2", "--block-tokens", "4",
             "--fleet-steps", "4", "--rate", "2"]
    for argv in (["--fleet"], ["--fleet", "--chaos", "kill_pe=2@1"],
                 ["--disagg", "--cross-pod", "--requests", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_serve.main(argv + small)
    fleet = Fleet(FleetConfig(), device="cpu")
    assert fleet.heap.device == torch.device("cpu")
    px = HostProxy(context.init(npes=2, node_size=1, device="cpu")[0])
    assert not px.ring_full()
    out = launch_serve.main(["--fleet", "--device", "cpu", "--chaos",
                             "kill_pe=2@1"] + small)
    assert out.heap.device == torch.device("cpu")
    assert out.last_report["fault"]["dead_pes"] == [2]
    sched = launch_serve.main(["--disagg", "--cross-pod", "--device", "cpu",
                               "--requests", "2"] + small[:6])
    assert sched.migrator.proxy is not None and \
        sched.stats.bytes_cross_pod == sched.stats.bytes_migrated > 0


@pytest.mark.parametrize("name", SLICE_9)
def test_slice_9_module_is_the_ports_own(name):
    """Each tune/obs module imports alone, without JAX or the reference,
    and is not the reference's module under another name."""
    code = (
        "import importlib, sys\n"
        f"mod = importlib.import_module('repro_torch.{name}')\n"
        "assert mod.__name__.startswith('repro_torch'), mod.__name__\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


# the dry-run and the roofline: the reference's launch/{dryrun,sharding,
# mesh,shardctx}.py and roofline/*, each the port's own
SLICE_10 = ("launch.dryrun", "launch.sharding", "launch.mesh",
            "launch.shardctx", "roofline", "roofline.counter",
            "roofline.analysis")


@pytest.mark.parametrize("name", SLICE_10)
def test_slice_10_module_is_the_ports_own(name):
    """Each dry-run and roofline module imports alone, without JAX or the
    reference (the reference's dryrun also sets XLA_FLAGS on import: the
    port's must not)."""
    code = (
        "import importlib, os, sys\n"
        f"mod = importlib.import_module('repro_torch.{name}')\n"
        "assert mod.__name__.startswith('repro_torch'), mod.__name__\n"
        "assert 'XLA_FLAGS' not in os.environ\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
    assert f"repro_torch.{name}" in MODULES


def test_dryrun_entry_points_run_on_the_card_unless_cpu_or_meta(no_card):
    """``init_params`` and ``dryrun.build_step`` default to the card; the
    caller may pass ``device="cpu"`` or ``device="meta"``."""
    from repro_torch.launch import dryrun
    cfg = base.reduced(base.get_config("qwen3_4b"))
    shape = base.ShapeSpec("d", "decode", 16, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.build_step(cfg, shape)
    for dev in ("cpu", "meta"):
        _, args = dryrun.build_step(cfg, shape, device=dev)
        assert args[0]["embed"].device.type == dev
        assert args[3]["blocks"][0]["k"].device.type == dev


TORCH_EXAMPLES = sorted(
    (Path(repro_torch.__file__).resolve().parents[2] / "examples")
    .glob("torch_*.py"))


def test_four_torch_examples():
    assert [p.name for p in TORCH_EXAMPLES] == [
        "torch_quickstart.py", "torch_serve_batch.py",
        "torch_shmem_collectives.py", "torch_train_lm.py"]


@pytest.mark.parametrize("path", TORCH_EXAMPLES, ids=lambda p: p.stem)
def test_torch_example_imports_without_jax_or_the_reference(path):
    """Each torch example imports ``repro_torch``, ``torch`` and numpy
    only: loading it pulls in neither JAX nor the JAX package, and no line
    of it imports them."""
    import ast
    for node in ast.walk(ast.parse(path.read_text())):
        names = [a.name for a in node.names] if isinstance(
            node, ast.Import) else [node.module] if isinstance(
                node, ast.ImportFrom) else []
        for name in names:
            assert name.split(".")[0] in (
                "argparse", "dataclasses", "time", "numpy", "torch",
                "repro_torch"), f"{path.name}: imports {name}"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": src}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
