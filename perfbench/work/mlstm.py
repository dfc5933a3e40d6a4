"""``mlstm``: an xLSTM matrix-memory block, the shapes of
``models/ssm.py::init_mlstm`` and its recurrent form ``mlstm_decode``:
wx, wz (d x d_in), wq, wk, wv (d_in x d_in), the gates wi, wf
(d_in x nh) and out_proj (d_in x d), with d_in = 2d and nh = num_heads
heads of dk = d_in / nh; and the memory's update and readout, C of
nh x dk x dk = d_in x dk words and n of d_in words (2 FLOPs a word each).
No attention over a cache."""


def token_flops(a: dict) -> float:
    d = a["d_model"]
    d_in = 2 * d
    nh = a["num_heads"]
    dk = d_in // nh
    return (2.0 * (2 * d * d_in + 3 * d_in * d_in + 2 * d_in * nh
                   + d_in * d)
            + 4.0 * (d_in * dk + d_in))


def context_flops(a: dict) -> float:
    return 0.0
