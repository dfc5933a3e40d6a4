"""A disaggregated serving run whose decode banks see admissions, evictions
and copy-on-write mid-flight, on any device: the traffic that the decode
graph's tests step (``tests/test_torch_decode_graph.py`` on the CPU,
``tests/test_torch_cuda.py`` on the card).  Imports nothing of JAX.

Prompts of 10-24 tokens and budgets of 3-16 tokens, in an order that
keeps every slot turning over; every fourth request is a sample of one
20-token prompt declared shared whole, so its first decode write lands in
the shared boundary block (blocks of 8) and copies it.
"""
import torch

from repro_torch.launch import serve

PROMPT, NEW = 24, 16


def build(arch: str, device: str, *, requests: int = 16, slots: int = 2,
          decode_pes: int = 2, temperature: float = 0.0, seed: int = 0,
          dense: bool = False):
    """The scheduler with its requests submitted and nothing run."""
    argv = ["--disagg", "--device", device, "--arch", arch, "--requests",
            "0", "--prompt-len", str(PROMPT), "--max-new", str(NEW),
            "--slots", str(slots), "--decode-pes", str(decode_pes),
            "--block-tokens", "8", "--kv-blocks", "192", "--temperature",
            str(temperature), "--seed", str(seed)]
    argv.append("--dense-rehydrate" if dense else "--shared-prefix")
    args = serve.parse_args(argv)
    cfg, params = serve._model(args)
    sched = serve._build_disagg(args, cfg, params)
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed + 7)
    shared = serve.make_batch(cfg, gen, 1, 20, device)
    for i in range(requests):
        max_new = 3 + (5 * i) % 14
        if i % 4 == 0 and not dense:
            sched.submit(dict(shared), max_new=max_new, prefix_len=20)
        else:
            sched.submit(serve.make_batch(cfg, gen, 1, 10 + (7 * i) % 15,
                                          device), max_new=max_new)
    return sched
