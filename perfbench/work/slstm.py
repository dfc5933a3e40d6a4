"""``slstm``: an xLSTM scalar-memory block, the shapes of
``models/ssm.py::init_slstm``: the input gates w_in (d x 4d), the
recurrent r (4 gates x nh heads of hd x hd, hd = d / nh) and the gated
feed-forward ff1 (d x 2 ffp) and ff2 (ffp x d), ffp = 4d/3 rounded up to
a multiple of 8.  The cell's element-wise work is left out.  No attention
over a cache."""


def token_flops(a: dict) -> float:
    d = a["d_model"]
    hd = d // a["num_heads"]
    ffp = -(-4 * d // 3 // 8) * 8
    return 2.0 * (4 * d * d + 4 * d * hd + 2 * d * ffp + ffp * d)


def context_flops(a: dict) -> float:
    return 0.0
