"""``moe``: self-attention and the routed experts of
``models/moe.py::init_moe``: the router (d x E), the ``experts_per_token``
experts a token is routed to, each an MLP of width ``d_ff``, and the
dense MLP of width ``moe_dense_ff`` beside them.  Only the active experts
count, whatever the capacity pads or drops."""
from perfbench.work import attention_context_flops, attn_params, mlp_params


def token_flops(a: dict) -> float:
    return 2.0 * (attn_params(a)
                  + a["experts_per_token"] * mlp_params(a, a["d_ff"])
                  + mlp_params(a, a["moe_dense_ff"])
                  + a["d_model"] * a["num_experts"])


def context_flops(a: dict) -> float:
    return attention_context_flops(a)
