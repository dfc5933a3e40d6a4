"""Four of the seven remaining configurations served disaggregated, at
reduced widths, against the JAX scheduler in lockstep
(``tests/_torch_lockstep.py``, the runner of ``tests/test_torch_serve.py``):
h2o-danube at 60-token prompts and a 76-token cache, above its window of
64, so the cache is a ring (every block migrates, ``kpos`` rides the f32
tail as int32 bits, the empty slots' -1 a NaN pattern compared bit for
bit, and decode wraps into slot 0); whisper with its audio embeddings
(the encoder's cross K/V in the tail); the vision model with its image
embeddings and its cross gates at 0.5, so they reach the tokens; and
llama4-scout's MoE.  A ring or multimodal batch asks for a shared prefix
and gets none.  Then the launcher serves each of the seven names.
"""
import pytest

from repro_torch.launch import serve as launch_serve

from _torch_lockstep import family_params, run_lockstep


LOCKSTEP = [
    pytest.param(dict(n_req=4, num_slots=2, admit_delay=1, S=60, max_len=76,
                      arch="h2o_danube_3_4b", prefix="whole"),
                 id="danube-ring"),
    pytest.param(dict(n_req=4, num_slots=2, admit_delay=1,
                      arch="whisper_medium", prefix="whole"), id="whisper"),
    pytest.param(dict(n_req=4, num_slots=1, admit_delay=1, stream_chunks=1,
                      arch="llama_3_2_vision_90b"), id="vision-stream1"),
    pytest.param(dict(n_req=5, num_slots=2, admit_delay=0,
                      arch="llama4_scout_17b_a16e"), id="llama4-moe"),
]


@pytest.mark.parametrize("case", LOCKSTEP)
def test_disagg_matches_reference_step_by_step(monkeypatch, case):
    """``tests/test_torch_serve.py``'s lockstep law for four of the seven:
    every step's control plane exactly, float pools within 5e-5 and their
    NaN words bit for bit, logits, trace events and tokens; then the
    case's own: no shared prefix on a ring or with embeddings, the ring
    wrapped, the embeddings reached the tokens."""
    run_lockstep(case, *family_params(case["arch"]), monkeypatch)


@pytest.mark.parametrize("arch,flags", [
    ("minitron-8b", []), ("h2o-danube-3-4b", []),
    ("h2o-danube-3-4b", ["--fused-attn"]), ("starcoder2-7b", []),
    ("llama4-scout-17b-a16e", []), ("arctic-480b", []),
    ("whisper-medium", []), ("llama-3.2-vision-90b", [])])
def test_launcher_serves_remaining_families_on_cpu(capsys, arch, flags):
    """``--arch`` takes the seven other names at reduced widths; the
    frontend embeddings ride each request's batch (drawn by ``make_batch``
    from the launcher's generator), danube's 70-token prompts make its
    cache a ring, also under the fused protocol; the counters balance, the
    pool drains, and every request equals the single-PE baseline
    bitwise."""
    S = 70 if arch.startswith("h2o") else 12
    sched = launch_serve.main(["--disagg", "--device", "cpu", "--arch", arch,
                               "--requests", "4", "--prompt-len", str(S),
                               "--max-new", "4", "--slots", "2"] + flags)
    st = sched.stats
    assert (st.prefills, st.migrations, st.admissions, st.evictions) == \
        (4, 4, 4, 4)
    assert sched.pool.stats()["blocks_in_use"] == 0
    assert sched.pool.layout.ring == arch.startswith("h2o")
    cfg = sched.engine.cfg
    key = {"audio": "audio_embeds", "vlm": "image_embeds"}.get(cfg.family)
    for req in sched.requests.values():
        assert sorted(req.batch) == sorted({"tokens", key} - {None})
        assert sched.engine.generate_in_slot(
            req.batch, sched.scfg, num_slots=2, slot=req.slot) == req.out
    assert f"[serve] disagg arch={arch}" in capsys.readouterr().out
