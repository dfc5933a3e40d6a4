"""The four torch examples (``examples/torch_*.py``) against the JAX
package, on the CPU at small sizes.

- quickstart: its printed lines equal ``examples/quickstart.py``'s, run
  as a subprocess, line for line (values, transport paths, the ledger's
  count and modeled total);
- serve_batch at ``--temperature 0``: act 1's greedy tokens equal the
  reference ``Engine.generate``'s, and acts 2 and 3's tokens and
  scheduler stats equal the reference ``DisaggScheduler``'s, exactly, on
  the prompts the example served and its weights carried into JAX;
- shmem_collectives: its results equal ``kernels/ref.py``'s oracles on
  its inputs (the psum within 1e-4, ``tests/test_comms_equiv.py``'s
  bound: the two sum in different orders);
- train_lm: ``make_cfg`` equals the reference's field by field, and four
  steps from one bridged state match the reference trainer's logged
  metrics within 1e-4 (``tests/test_torch_trainer.py``'s bound).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import context as ref_context, teams as ref_teams
from repro.kernels import ref as ref_kernels
from repro.serve import engine as ref_engine
from repro.serve.kvpool import KVPool as RefKVPool
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.scheduler import DisaggScheduler as RefScheduler
from repro.train import train_step as ref_ts, trainer as ref_trainer
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.models import model
from _torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_batch", "shmem_collectives", "train_lm")


def _load(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_stdout(name):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" /
                                              f"{name}.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _to_jax(tree):
    """The port's weights as the reference's tree of arrays."""
    def leaf(t):
        a = t.detach().float().numpy()
        return jnp.asarray(a).astype(str(t.dtype).removeprefix("torch."))
    return jax.tree.map(leaf, tree)


def test_quickstart_prints_the_reference_lines(capsys):
    want = _reference_stdout("quickstart")
    got = _load("torch_quickstart").main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert got["get3"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got["ledger_ops"] == 14 and got["ring_msgs"] == 1
    assert f"modeled total {got['modeled_total_us']:.1f} us" in want


def test_serve_batch_greedy_matches_reference(capsys):
    ex = _load("torch_serve_batch")
    got = ex.main(["--device", "cpu", "--temperature", "0"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 + 4 + 4
    assert set(got["temperature"].values()) == {0.0}

    # act 1: Engine.generate, greedy, per family
    for arch in ex.ACT1_ARCHS:
        rc = ref_base.reduced(ref_base.get_config(arch))
        pc = base.reduced(base.get_config(arch))
        rp = _to_jax(model.init_params(pc, seed=0, device="cpu"))
        act = got["act1"][arch]
        batch = {k: jnp.asarray(v) for k, v in act["batch"].items()}
        want = ref_engine.Engine(rc, rp, max_len=ex.S1 + ex.NEW1).generate(
            batch, ref_engine.ServeConfig(max_new_tokens=ex.NEW1))
        np.testing.assert_array_equal(act["generated"], np.asarray(want))

    # acts 2 and 3: the reference's scheduler on the same prompts
    rc = ref_base.reduced(ref_base.get_config("qwen3-4b"))
    pc = base.reduced(base.get_config("qwen3-4b"))
    rp = _to_jax(model.init_params(pc, seed=0, device="cpu"))
    eng = ref_engine.Engine(rc, rp, max_len=ex.S + ex.NEW)
    pre, dec = ref_teams.disagg_partition(ref_teams.world(ex.NPES), 2)
    for act, kw in (("act2", dict(block_tokens=8)),
                    ("act3", dict(block_tokens=4))):
        ctx, heap = ref_context.init(npes=ex.NPES, node_size=ex.NPES)
        pool = RefKVPool.create(heap, rc, ex.S + ex.NEW, num_blocks=24,
                                max_slots=2, **kw)
        extra = {} if act == "act2" else dict(stream_chunks=1,
                                              shared_prefix=True)
        sched = RefScheduler(
            ctx, heap, eng, pool, RefKVMigrator(ctx, pool),
            prefill_pes=pre.pes(), decode_pes=dec.pes(), num_slots=2,
            scfg=ref_engine.ServeConfig(max_new_tokens=ex.NEW,
                                        seed=4 if act == "act3" else 0),
            admit_delay_steps=1, **extra)
        if act == "act2":
            for p in got[act]["prompts"]:
                sched.submit({"tokens": jnp.asarray(p)})
        else:
            for _ in range(6):
                sched.submit({"tokens": jnp.asarray(got[act]["prompt"])},
                             prefix_len=ex.S - 2)
        outs = sched.run()
        assert sorted(outs) == sorted(got[act]["outs"])
        for rid, toks in outs.items():
            np.testing.assert_array_equal(got[act]["outs"][rid],
                                          np.asarray(toks))
        want = dataclasses.asdict(sched.stats)
        assert {k: got[act]["stats"][k] for k in want} == want, act


def test_shmem_collectives_match_the_reference_oracles(capsys):
    got = _load("torch_shmem_collectives").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    want = _reference_stdout("shmem_collectives").splitlines()
    assert [ln.split(":")[0] for ln in lines] == \
        [ln.split(":")[0] for ln in want]
    x, xa = jnp.asarray(got["x"]), jnp.asarray(got["xa"])
    np.testing.assert_array_equal(got["fcollect"],
                                  np.asarray(ref_kernels.ring_allgather(x)))
    np.testing.assert_array_equal(
        got["broadcast"], np.asarray(ref_kernels.push_broadcast(x, 2)))
    assert got["fcollect_ok"] and got["broadcast_ok"] and got["barrier_ok"]
    assert got["barrier"] == [1] * 8
    np.testing.assert_allclose(
        got["psum_shmem"], np.asarray(ref_kernels.ring_allreduce(xa)),
        rtol=1e-4, atol=1e-4)
    assert got["psum_err"] <= 1e-4


def test_train_lm_make_cfg_equals_the_reference():
    ex, ref_ex = _load("torch_train_lm"), _load("train_lm")
    for d, layers, vocab in ((256, 4, 4096), (640, 10, 50304), (64, 2, 512)):
        got, want = ex.make_cfg(d, layers, vocab), \
            ref_ex.make_cfg(d, layers, vocab)
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert {k: g[k] for k in w} == w
        # the port's own fields (latent attention) keep their defaults
        assert all(g[f.name] == f.default for f in dataclasses.fields(got)
                   if f.name not in w)
        assert got.param_count() == want.param_count()


def test_train_lm_history_matches_reference(tmp_path, capsys):
    ex, ref_ex = _load("torch_train_lm"), _load("train_lm")
    rc = ref_ex.make_cfg(64, 2, 512)
    steps, seq, batch = 4, 32, 4
    _, _, want = ref_trainer.train(rc, ref_trainer.TrainConfig(
        steps=steps, seq_len=seq, global_batch=batch, log_every=1,
        ckpt_dir=str(tmp_path)), log_fn=lambda *_: None)
    rp, ro = ref_ts.init_state(jax.random.key(0), rc)
    state = (_bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu"),
             _bridge.opt_state_to_torch(jax.tree.map(np.asarray, ro), "cpu"))
    got = ex.main(["--device", "cpu", "--d-model", "64", "--layers", "2",
                   "--vocab", "512", "--steps", str(steps), "--seq-len",
                   str(seq), "--batch", str(batch)], state=state,
                  log_fn=lambda *_: None)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train_lm] qwen3-4b-derived dense LM")
    assert lines[-1].startswith(f"[train_lm] loss {got['first']:.4f} -> ")
    assert [h["step"] for h in got["history"]] == \
        [h["step"] for h in want] == list(range(steps))
    for g, w in zip(got["history"], want):
        for key in ("loss", "ce", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {g['step']} {key}")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_card_unless_cpu(name):
    """Without ``--device`` an example takes the current CUDA device, and
    raises on a machine with none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    argv = ["--steps", "1"] if name == "train_lm" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(f"torch_{name}").main(argv)
