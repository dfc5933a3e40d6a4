"""State-space and recurrent blocks (counterpart of ``repro/models/ssm.py``).

- Mamba2 (SSD): chunked scan, a quadratic form inside each chunk of 64 and
  a linear state recurrence from chunk to chunk;
- mLSTM (xLSTM): chunked matrix-memory linear attention with exponential
  gating and a running log-stabiliser;
- sLSTM (xLSTM): a true per-timestep recurrence through h.

Everything recurrent accumulates in float32, as the reference does.  The
reference's ``lax.scan`` loops are Python loops here: over chunks for Mamba2
and mLSTM, each emitting the state entering its chunk, over timesteps for
sLSTM.  The reference has no Pallas kernel in these blocks, so their
products stay ``torch.matmul`` and ``torch.einsum``.  Weights are stacked
over ``reps`` layers on axis 0, like the other block kinds of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm, silu

MAMBA_CHUNK = 64
MLSTM_CHUNK = 64
MAMBA_HEADDIM = 64
NEG_INF = -1e30


def _chunk(s, want):
    """The largest divisor of ``s`` that is at most ``want``."""
    c = min(want, s)
    while s % c:
        c -= 1
    return max(c, 1)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) without torch's linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def mamba_dims(cfg):
    """(d_inner, head width p, heads, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    p = MAMBA_HEADDIM if d_in % MAMBA_HEADDIM == 0 else max(
        x for x in (32, 16, 8) if d_in % x == 0)
    return d_in, p, d_in // p, cfg.ssm_state


def init_mamba(gen, cfg, dtype, *, reps, device=None):
    d = cfg.d_model
    d_in, p, nh, N = mamba_dims(cfg)
    conv_dim = d_in + 2 * N

    def w(shape, **kw):
        return dense_init(gen, (reps, *shape), dtype=dtype, device=device,
                          **kw)

    def full(shape, value, dt):
        return torch.full((reps, *shape), value, dtype=dt, device=device)

    f32 = torch.float32
    return {
        "norm": full((d,), 1.0, dtype),
        "wz": w((d, d_in)), "wx": w((d, d_in)), "wB": w((d, N)),
        "wC": w((d, N)), "wdt": w((d, nh)),
        "dt_bias": full((nh,), 0.0, f32),
        "A_log": full((nh,), 0.0, f32),
        "D": full((nh,), 1.0, f32),
        "conv_w": w((cfg.ssm_conv, conv_dim), scale=0.3),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "out_proj": w((d_in, d)),
    }


def causal_conv(x, w, b):
    """Depthwise causal conv as shifted adds.  x: (B,S,D); w: (K,D)."""
    K = w.shape[0]
    out = torch.zeros_like(x) + b
    for j in range(K):
        shift = K - 1 - j
        xs = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :-shift]
        out = out + xs * w[j]
    return out


def _mamba_project(p, x):
    return (x @ p["wz"], x @ p["wx"], x @ p["wB"], x @ p["wC"],
            x @ p["wdt"])


def mamba_forward(p, x, cfg, state=None, conv_cache=None):
    """Full-sequence Mamba2.  x: (B,S,d).  Returns (y, final_state,
    conv_tail): the state (B,nh,p,N) in f32, and the conv window's last
    K-1 inputs in x's dtype (the cache leaf holds it as f32;
    :func:`mamba_decode` casts it back)."""
    B, S, d = x.shape
    d_in, hp, nh, N = mamba_dims(cfg)
    z, xr, Bm, Cm, dt_raw = _mamba_project(p, x)

    xBC = torch.cat([xr, Bm, Cm], dim=-1)
    if conv_cache is not None:                    # continue from cached tail
        full = torch.cat([conv_cache.to(xBC.dtype), xBC], 1)
        conv = causal_conv(full, p["conv_w"], p["conv_b"])[
            :, conv_cache.shape[1]:]
    else:
        conv = causal_conv(xBC, p["conv_w"], p["conv_b"])
    conv = silu(conv)
    K = cfg.ssm_conv
    conv_tail = torch.cat([xBC.new_zeros((B, K - 1, xBC.shape[-1])), xBC],
                          1)[:, -(K - 1):]
    xr = conv[..., :d_in]
    Bm = conv[..., d_in:d_in + N].float()
    Cm = conv[..., d_in + N:].float()

    dt = _softplus(dt_raw.float() + p["dt_bias"])                 # (B,S,nh)
    a = -torch.exp(p["A_log"])                                    # (nh,)
    dA = dt * a
    xh = xr.reshape(B, S, nh, hp).float()
    xdt = xh * dt[..., None]                                      # (B,S,nh,p)

    L = _chunk(S, MAMBA_CHUNK)
    nc = S // L
    dA_c = dA.reshape(B, nc, L, nh)
    x_c = xdt.reshape(B, nc, L, nh, hp)
    B_c = Bm.reshape(B, nc, L, N)
    C_c = Cm.reshape(B, nc, L, N)

    cs = torch.cumsum(dA_c, dim=2)                                # (B,nc,L,nh)
    tot = cs[:, :, -1]                                            # (B,nc,nh)

    # intra-chunk: the decay exp(cs_l - cs_s) overflows above the diagonal,
    # so the mask selects (0 * inf would be NaN)
    G = torch.einsum("bcln,bcsn->bcls", C_c, B_c)                 # (B,nc,L,L)
    idx = torch.arange(L, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    decay = torch.exp(cs[:, :, :, None, :] - cs[:, :, None, :, :])
    W = torch.where(causal[None, None, :, :, None], G[..., None] * decay,
                    torch.zeros((), device=x.device))
    y_intra = torch.einsum("bclsh,bcshp->bclhp", W, x_c)

    # per-chunk local end state: sum_s exp(tot - cs_s) x_s B_s^T
    sdecay = torch.exp(tot[:, :, None, :] - cs)                   # (B,nc,L,nh)
    local_state = torch.einsum("bclh,bclhp,bcln->bchpn", sdecay, x_c, B_c)

    # inter-chunk recurrence, emitting the state entering each chunk
    carry = (x.new_zeros((B, nh, hp, N), dtype=torch.float32)
             if state is None else state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(tot[:, c])[..., None, None] + \
            local_state[:, c]
    prev_states = torch.stack(prev, dim=1)                        # (B,nc,nh,p,N)

    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", C_c, prev_states,
                           torch.exp(cs))
    y = (y_intra + y_inter).reshape(B, S, nh, hp)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * silu(z)
    return y @ p["out_proj"], carry, conv_tail


def mamba_decode(p, x, cfg, state, conv_cache):
    """Single-token step.  x: (B,1,d); state: (B,nh,p,N);
    conv_cache: (B,K-1,conv_dim)."""
    B = x.shape[0]
    d_in, hp, nh, N = mamba_dims(cfg)
    z, xr, Bm, Cm, dt_raw = _mamba_project(p, x)
    xBC = torch.cat([xr, Bm, Cm], dim=-1)[:, 0]                   # (B,conv_dim)
    window = torch.cat([conv_cache.to(xBC.dtype), xBC[:, None]], 1)
    conv = silu((window * p["conv_w"][None]).sum(1) + p["conv_b"])
    new_conv_cache = window[:, 1:]

    xr = conv[:, :d_in]
    Bm = conv[:, d_in:d_in + N].float()
    Cm = conv[:, d_in + N:].float()
    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])           # (B,nh)
    a = -torch.exp(p["A_log"])
    xh = xr.reshape(B, nh, hp).float()

    decay = torch.exp(dt * a)                                     # (B,nh)
    upd = torch.einsum("bhp,bn->bhpn", xh * dt[..., None], Bm)
    new_state = state.float() * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, new_state)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, d_in).to(x.dtype) * silu(z[:, 0])
    return (y @ p["out_proj"])[:, None], new_state, new_conv_cache


# ===========================================================================
# mLSTM (xLSTM matrix-memory cell)
# ===========================================================================


def mlstm_dims(cfg):
    d_in = 2 * cfg.d_model
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def init_mlstm(gen, cfg, dtype, *, reps, device=None):
    d = cfg.d_model
    d_in, nh, dk = mlstm_dims(cfg)
    f32 = torch.float32

    def w(shape, dt=dtype, **kw):
        return dense_init(gen, (reps, *shape), dtype=dt, device=device, **kw)

    return {
        "norm": torch.ones((reps, d), dtype=dtype, device=device),
        "wx": w((d, d_in)), "wz": w((d, d_in)),
        "wq": w((d_in, d_in)), "wk": w((d_in, d_in)), "wv": w((d_in, d_in)),
        "wi": w((d_in, nh), f32, scale=0.02),
        "wf": w((d_in, nh), f32, scale=0.02),
        # open forget gates at init
        "f_bias": torch.full((reps, nh), 3.0, dtype=f32, device=device),
        "gnorm": torch.ones((reps, d_in), dtype=dtype, device=device),
        "out_proj": w((d_in, d)),
    }


def _mlstm_qkvif(p, x, cfg):
    B, S, _ = x.shape
    d_in, nh, dk = mlstm_dims(cfg)
    xi = x @ p["wx"]
    z = x @ p["wz"]
    q = (xi @ p["wq"]).reshape(B, S, nh, dk).float() * dk ** -0.5
    k = (xi @ p["wk"]).reshape(B, S, nh, dk).float()
    v = (xi @ p["wv"]).reshape(B, S, nh, dk).float()
    i_g = xi.float() @ p["wi"]                                    # (B,S,nh)
    f_g = xi.float() @ p["wf"] + p["f_bias"]
    return z, q, k, v, i_g, f_g


def mlstm_forward(p, x, cfg, state=None):
    """x: (B,S,d) -> (y, new_state); state = (C, n, m)."""
    B, S, d = x.shape
    d_in, nh, dk = mlstm_dims(cfg)
    z, q, k, v, i_g, f_g = _mlstm_qkvif(p, x, cfg)
    logf = -_softplus(-f_g)                                       # log sigmoid

    L = _chunk(S, MLSTM_CHUNK)
    nc = S // L

    def rs(t):
        return t.reshape(B, nc, L, *t.shape[2:])

    qc, kc, vc, ic, fc = rs(q), rs(k), rs(v), rs(i_g), rs(logf)
    b = torch.cumsum(fc, dim=2)                                   # (B,nc,L,nh)
    btot = b[:, :, -1]                                            # (B,nc,nh)

    f32 = dict(dtype=torch.float32, device=x.device)
    if state is None:
        C = torch.zeros((B, nh, dk, dk), **f32)
        n = torch.zeros((B, nh, dk), **f32)
        m = torch.full((B, nh), NEG_INF, **f32)
    else:
        C, n, m = (s.float() for s in state)

    idx = torch.arange(L, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    hs = []
    for c in range(nc):
        qq, kk, vv = qc[:, c], kc[:, c], vc[:, c]
        ii, bb, bt = ic[:, c], b[:, c], btot[:, c]
        # log weights inside the chunk: g[t,s] = b_t - b_s + i_s (s <= t)
        g = bb[:, :, None, :] - bb[:, None, :, :] + ii[:, None, :, :]
        g = torch.where(causal[None, :, :, None], g,
                        torch.full((), NEG_INF, **f32))
        m_intra = g.amax(dim=2)                                   # (B,L,nh)
        m_inter = m[:, None] + bb
        m_t = torch.maximum(m_intra, m_inter)
        w = torch.exp(g - m_t[:, :, None, :])                     # (B,L,L,nh)
        qk = torch.einsum("blhd,bshd->blsh", qq, kk)
        wqk = qk * w
        num = torch.einsum("blsh,bshd->blhd", wqk, vv)
        den = wqk.sum(dim=2)                                      # (B,L,nh)
        carry_scale = torch.exp(m_inter - m_t)
        num = num + carry_scale[..., None] * torch.einsum(
            "blhd,bhde->blhe", qq, C)
        den = den + carry_scale * torch.einsum("blhd,bhd->blh", qq, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # carry to the end of the chunk
        m_loc = (bt[:, None, :] - bb + ii).amax(dim=1)            # (B,nh)
        m_new = torch.maximum(m + bt, m_loc)
        sdecay = torch.exp(bt[:, None, :] - bb + ii - m_new[:, None, :])
        scale = torch.exp(m + bt - m_new)
        C = C * scale[..., None, None] + torch.einsum(
            "blh,blhd,blhe->bhde", sdecay, kk, vv)
        n = n * scale[..., None] + torch.einsum("blh,blhd->bhd", sdecay, kk)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, d_in)
    h = rms_norm(h.to(x.dtype), p["gnorm"])
    y = (h * silu(z)) @ p["out_proj"]
    return y, (C, n, m)


def mlstm_decode(p, x, cfg, state):
    """x: (B,1,d); state = (C, n, m)."""
    B = x.shape[0]
    d_in, nh, dk = mlstm_dims(cfg)
    z, q, k, v, i_g, f_g = _mlstm_qkvif(p, x, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                           # (B,nh,dk)
    i_g, f_g = i_g[:, 0], f_g[:, 0]                               # (B,nh)
    logf = -_softplus(-f_g)
    C, n, m = (s.float() for s in state)
    m_new = torch.maximum(logf + m, i_g)
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(i_g - m_new)
    C_new = C * fs[..., None, None] + is_[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n_new = n * fs[..., None] + is_[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.einsum("bhd,bhd->bh", q, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = rms_norm(h.reshape(B, d_in).to(x.dtype), p["gnorm"])
    y = (h * silu(z[:, 0])) @ p["out_proj"]
    return y[:, None], (C_new, n_new, m_new)


# ===========================================================================
# sLSTM (xLSTM scalar cell with true recurrence)
# ===========================================================================


def slstm_dims(cfg):
    nh = cfg.num_heads
    return nh, cfg.d_model // nh


def init_slstm(gen, cfg, dtype, *, reps, device=None):
    d = cfg.d_model
    nh, hd = slstm_dims(cfg)
    ffp = -(-4 * d // 3 // 8) * 8
    f32 = dict(dtype=torch.float32, device=device)
    bias = torch.cat([torch.zeros((2 * d,), **f32),
                      torch.full((d,), 3.0, **f32),
                      torch.zeros((d,), **f32)])

    def w(shape, dt=dtype, **kw):
        return dense_init(gen, (reps, *shape), dtype=dt, device=device, **kw)

    return {
        "norm": torch.ones((reps, d), dtype=dtype, device=device),
        "w_in": w((d, 4 * d)),                                    # z,i,f,o
        "r": w((4, nh, hd, hd), torch.float32, scale=hd ** -0.5),
        "bias": bias.expand(reps, 4 * d).clone(),
        "gnorm": torch.ones((reps, d), dtype=dtype, device=device),
        "ff1": w((d, 2 * ffp)),
        "ff2": w((ffp, d)),
    }


def _slstm_cell(p, xg, state, cfg):
    """One timestep.  xg: (B,4d) input gates; state = (c, n, m, h)."""
    B = xg.shape[0]
    d = cfg.d_model
    nh, hd = slstm_dims(cfg)
    c, n, m, h = state
    rec = torch.einsum("bkh,gkhf->bgkf", h.reshape(B, nh, hd),
                       p["r"]).reshape(B, 4 * d)
    gates = xg.float() + rec + p["bias"]
    zr, ir, fr, orr = gates.split(d, dim=-1)
    z = torch.tanh(zr)
    o = torch.sigmoid(orr)
    logf = -_softplus(-fr)
    m_new = torch.maximum(logf + m, ir)
    c_new = torch.exp(logf + m - m_new) * c + torch.exp(ir - m_new) * z
    n_new = torch.exp(logf + m - m_new) * n + torch.exp(ir - m_new)
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new)


def _slstm_out(p, h):
    h = rms_norm(h, p["gnorm"])
    u, g = (h @ p["ff1"]).chunk(2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    return (F.gelu(g, approximate="tanh") * u) @ p["ff2"]


def slstm_forward(p, x, cfg, state=None):
    """x: (B,S,d) -> (y, new_state), one timestep at a time."""
    B, S, d = x.shape
    xg = x @ p["w_in"]                                            # (B,S,4d)
    if state is None:
        zeros = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, torch.full_like(zeros, NEG_INF), zeros)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, xg[:, t], state, cfg)
        hs.append(state[3])
    return _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype)), state


def slstm_decode(p, x, cfg, state):
    xg = (x @ p["w_in"])[:, 0]
    state = _slstm_cell(p, xg, state, cfg)
    return _slstm_out(p, state[3][:, None].to(x.dtype)), state
