"""``mla``: a multi-head latent attention block (DeepSeek-V2, no q LoRA)
and its dense MLP of width ``first_dense_ff``, the shapes of
``models/attention.py::init_mla`` and ``models/model.py::_init_block``
for ``"mla"`` as the port has them at this file's commit.  The count is
the published, expanded form, whatever form the program computes: the
projections q (d x H(nope + rope)), kv_a (d x (latent + rope)), kv_b
(latent x H(nope + v)) and o (H v x d); per visible position, QK^T over
nope + rope and PV over v for each of the H heads."""
from perfbench.work import mlp_params


def mla_params(a: dict) -> int:
    d, H, r = a["d_model"], a["num_heads"], a["kv_lora_rank"]
    dn, dr, dv = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                  a["v_head_dim"])
    return d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d


def token_flops(a: dict) -> float:
    return 2.0 * (mla_params(a) + mlp_params(a, a["first_dense_ff"]))


def context_flops(a: dict) -> float:
    return 2.0 * a["num_heads"] * (a["qk_nope_head_dim"]
                                   + a["qk_rope_head_dim"] + a["v_head_dim"])
