"""``mamba``: a Mamba2 block, the shapes of ``models/ssm.py::init_mamba``
and its recurrent form ``mamba_decode``: the projections wz, wx (d x d_in),
wB, wC (d x N), wdt (d x nh) and out_proj (d_in x d); the depthwise causal
conv of width K over d_in + 2N channels; and the state update and readout
over nh x p x N = d_in x N state words (2 FLOPs a word each).  No
attention over a cache."""

HEADDIM = 64        # models/ssm.py::MAMBA_HEADDIM


def dims(a: dict) -> tuple:
    """(d_in, heads, N), as ``models/ssm.py::mamba_dims`` sets them."""
    d_in = a["ssm_expand"] * a["d_model"]
    p = HEADDIM if d_in % HEADDIM == 0 else max(
        x for x in (32, 16, 8) if d_in % x == 0)
    return d_in, d_in // p, a["ssm_state"]


def token_flops(a: dict) -> float:
    d = a["d_model"]
    d_in, nh, N = dims(a)
    return (2.0 * (2 * d * d_in + 2 * d * N + d * nh + d_in * d)
            + 2.0 * a["ssm_conv"] * (d_in + 2 * N) + 4.0 * d_in * N)


def context_flops(a: dict) -> float:
    return 0.0
