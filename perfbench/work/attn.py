"""``attn``: a self-attention block and its dense MLP
(``models/model.py::_init_block`` for ``"attn"``; the MLP only where
``d_ff`` is not 0)."""
from perfbench.work import attention_context_flops, attn_params, mlp_params


def token_flops(a: dict) -> float:
    return 2.0 * (attn_params(a) + mlp_params(a, a["d_ff"]))


def context_flops(a: dict) -> float:
    return attention_context_flops(a)
