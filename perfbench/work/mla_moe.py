"""``mla_moe``: multi-head latent attention (``perfbench/work/mla.py``)
and DeepSeekMoE, the shapes of ``models/moe.py::init_moe`` as the port has
them at this file's commit: the router (d x E), the
``experts_per_token`` routed experts a token runs, each an MLP of width
``d_ff``, and the shared experts, one MLP of width ``moe_dense_ff``.
Only the active experts count, however the program dispatches."""
from perfbench.work import mlp_params
from perfbench.work.mla import context_flops, mla_params  # noqa: F401


def token_flops(a: dict) -> float:
    return 2.0 * (mla_params(a)
                  + a["experts_per_token"] * mlp_params(a, a["d_ff"])
                  + mlp_params(a, a["moe_dense_ff"])
                  + a["d_model"] * a["num_experts"])
