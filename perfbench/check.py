"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed and holding the
longest of them, is run once through the plain reference over each
prompt with its served tokens.  At every served position the reading is
the gap by which the served token's reference logit lies below the
reference's best; the number compared is the widest gap over the sample.
Greedy decoding in the configuration's precision serves the best token
or a near tie, so the gap stays at rounding; a path that drops, misplaces
or corrupts KV, or a token altered where it is produced, serves tokens
far down the reference's ranking.

The control (``perfbench/control.py``) puts the reference in the
program's place in the precision below the configuration's (float8
weights for bfloat16) and reads, at the same positions, the gap of the
token that lower precision puts first.
"""
from __future__ import annotations

import time

import numpy as np
import torch

CHECK_MIN_TOKENS = 128      # fewer served tokens than this: nothing to judge


def sample(finished: list, seed: int, min_tokens: int) -> list:
    """The longest finished request (prompt plus served tokens), then
    others in an order drawn from the seed, until the sample serves
    ``min_tokens`` tokens.  ``finished``: [(prompt (S,), served list)]."""
    if not finished:
        return []
    size = [len(p) + len(o) for p, o in finished]
    first = int(np.argmax(size))
    rng = np.random.default_rng(np.random.PCG64([int(seed), 2]))
    order = [first] + [int(i) for i in rng.permutation(len(finished))
                       if i != first]
    out, n = [], 0
    for i in order:
        out.append(finished[i])
        n += len(finished[i][1])
        if n >= min_tokens:
            break
    return out


def _inputs(prompt, served, device):
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    S = len(prompt)
    rows = torch.arange(S - 1, S - 1 + len(served), device=device)
    return torch.from_numpy(seq).to(device), rows


def _below_best(lg, picks):
    return lg.max(-1).values - lg.gather(-1, picks)[:, 0]


@torch.no_grad()
def served_gaps(ref, params, arch: dict, samples: list, device,
                control=None) -> tuple:
    """(program, control): per served token, the reference's best logit
    minus the served token's at the position that produced it; with
    ``control`` (a rounding of the weights, ``common.fp8_weight``), the
    same for the token the reference computed with it puts first."""
    prog, ctrl = [], []
    for prompt, served in samples:
        tokens, rows = _inputs(prompt, served, device)
        lg = ref.logits(params, arch, tokens, rows)
        idx = torch.as_tensor(served, device=device)[:, None]
        prog.extend(_below_best(lg, idx).tolist())
        if control is not None:
            low = ref.logits(params, arch, tokens, rows, w=control)
            ctrl.extend(_below_best(lg, low.argmax(-1, keepdim=True))
                        .tolist())
    return prog, ctrl


class ServedCheck:
    """``job.checker`` of a serving cell.  With ``control`` (a rounding of
    the weights, ``common.fp8_weight``) it also reads the control at the
    same positions and keeps its check, judged by the same limits, as
    ``control_check``."""

    def __init__(self, job, limits: dict, control=None):
        self.job = job
        self.limits = limits
        self.control = control
        self.control_check = None

    def __call__(self, params, finished: list) -> dict:
        job = self.job
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        picked = sample(finished, job.seed, int(job.mix["check_tokens"]))
        gaps, ctrl = served_gaps(job.reference, params, job.arch, picked,
                                 job.device, control=self.control)
        job.log(f"check: {len(picked)} of {len(finished)} finished "
                f"requests, {len(gaps)} served tokens, reference "
                f"{time.perf_counter() - t0:.1f} s")
        if self.control is not None:
            self.control_check = self.compare(ctrl)
        return self.compare(gaps)

    def compare(self, gaps: list) -> dict:
        """The numbers compared, each beside its limit."""
        return {
            "max_logit_gap": {"value": max(gaps) if gaps else None,
                              "limit": self.limits.get("max_logit_gap")},
            "served_tokens_checked": {
                "value": len(gaps),
                "limit": CHECK_MIN_TOKENS, "at_least": True},
        }
