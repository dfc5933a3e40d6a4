"""``shared_attn``: zamba2's one weight-shared attention block
(``models/model.py::init_params``, ``params["shared_attn"]``), the shapes
of ``attn``.  Its weights are stored once, but a token passes through them
at every layer that uses them, so each use counts in full."""
from perfbench.work import attn

token_flops = attn.token_flops
context_flops = attn.context_flops
