"""Selective state-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

Port of ``repro/models/ssm.py``, in plain PyTorch (the reference computes
these blocks outside any Pallas kernel).  Both share the recurrence

    h_t = a_t * h_{t-1} + b_t          (elementwise in the state)
    (a, b) o (a', b') = (a*a', a'*b + b')

computed by :func:`_assoc_scan`, a copy of ``jax.lax.associative_scan``'s
odd/even recursion with its pairing and its operand order, so that the
float32 results round as the reference's do and the scan is about
2 log2(S) levels of elementwise ops.  Mamba-1: per-channel diagonal A
(d_inner, N).  Mamba-2 (SSD): scalar decay per head; state (heads, head_p,
N), with the reference's chunked matmul form (``_ssd_chunked``, intra-chunk
math in bfloat16) where the sequence tiles into chunks of ``SSD_CHUNK``.
Decode carries (conv_state, ssm_state) and costs O(1) in sequence length.

The modules allocate their weights and set their constant leaves
(``A_log``, ``D``, ``dt_bias``, ``conv_b``, ``norm_w``) as the reference's
initializers do; ``common.draw_weights`` draws the rest.  ``A_log`` and
``D`` are float32 in every config, as are the SSM states.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import (batch_only, grad_replicated, model_divides,
                              on_local_shards, split_locally, whole_dim)
from .common import dtype_of, einsum, matmul, softplus

SCAN_CHUNK = 512  # sequence chunk for the chunked recurrence (memory knob)
SSD_CHUNK = 256  # SSD chunk length (matmul-form path)
RMS_EPS = 1e-5  # the gated RMSNorm's literal eps (not cfg.norm_eps)


def _combine(ax, bx, ay, by):
    """The reference's ``comb(x, y)``: x the earlier element."""
    return ax * ay, ay * bx + by


def _interleave(even, odd):
    """Positions 0, 2, ... from ``even``, 1, 3, ... from ``odd`` (axis 1),
    without writing into strided slices (DTensor's backward of such a
    write cannot bring its gradient to the buffer's layout)."""
    n_o = odd.shape[1]
    pairs = torch.stack([even[:, :n_o], odd], dim=2)  # (B, n_o, 2, ...)
    out = pairs.reshape((even.shape[0], 2 * n_o) + tuple(even.shape[2:]))
    if even.shape[1] > n_o:
        out = torch.cat([out, even[:, n_o:]], dim=1)
    return out


def _scan(a, b):
    """``associative_scan``'s ``_scan`` on the pair (a, b) along axis 1."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs (0, 1), (2, 3), ...; recurse on the halves
    oa, ob = _scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2],
                             a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _assoc_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 (seq). a, b: (B, S, ...).

    ``a`` may have size-1 trailing axes where ``b`` is wider (Mamba-2's
    per-head decay): its products are the same values the reference
    computes over the broadcast tensor."""
    return _scan(a, b)[1]


def _chunked_assoc_scan(a, b, h0=None):
    """Associative scan in sequential chunks: live memory O(B * chunk *
    state).  h0: optional initial state (B, ...) folded into the first
    step.  Returns (h, last_state).  Above ``SCAN_CHUNK`` the sequence must
    be a multiple of it, as the reference asserts (nothing is padded)."""
    B, S = a.shape[0], a.shape[1]
    chunk = SCAN_CHUNK
    if S <= chunk:
        if h0 is not None:
            b = b.clone()
            b[:, 0] = b[:, 0] + a[:, 0] * h0
        h = _assoc_scan(a, b)
        return h, h[:, -1]
    if S % chunk:
        raise ValueError(
            f"a sequence of {S} above the scan chunk of {chunk} must be a "
            f"multiple of it; the reference asserts S % chunk == 0 too")
    h = torch.zeros((B,) + tuple(b.shape[2:]), dtype=a.dtype,
                    device=a.device) if h0 is None else h0
    out = []
    for c in range(S // chunk):
        ac, bc = a[:, c * chunk:(c + 1) * chunk], b[:, c * chunk:(c + 1) * chunk]
        bc = bc.clone()
        bc[:, 0] = bc[:, 0] + ac[:, 0] * h
        hc = _assoc_scan(ac, bc)
        h = hc[:, -1]
        out.append(hc)
    return torch.cat(out, dim=1), h


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C).

    Returns (y, new_state) where state is the trailing K-1 inputs (zero
    padded when the sequence is shorter).  The taps are summed in order,
    from Python's 0, as the reference's ``sum`` does."""
    K = w.shape[0]
    pad = x.new_zeros((x.shape[0], K - 1, x.shape[2])) if state is None \
        else state
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y + b, new_state


def _decode_conv(new, w, b, state):
    """One step of the conv: (xp * w).sum over the K taps, as the
    reference's decode computes it.  Returns (y, new_state)."""
    xp = torch.cat([state, new[:, None]], dim=1)
    return (xp * w[None]).sum(1) + b, xp[:, 1:]


# -- on a mesh: each rank's own channels ---------------------------------------
#
# Where the model axis divides the mixer's channels (Mamba-1's d_inner,
# Mamba-2's heads), each rank runs its own share of them, as the
# reference's compiled program does: GSPMD propagates the split of
# ``conv_w``, ``x_proj``, ``A_log`` and ``out_proj`` back into the
# replicated ``in_proj``.  The conv and the scan are elementwise in the
# channels, so they run on each rank's local shards
# (``dist.sharding.on_local_shards``), split by batch and by channel as
# their operands arrive.  Plain tensors call them directly.

_BSC = {"batch": 0, "chan": 2}  # (B, S, C) and a conv state (B, K-1, C)


def _channels(cfg, x):
    """The index of the ``model`` mesh axis where DTensor ``x`` lies on a
    mesh whose model axis (of more than one rank) divides the mixer's
    channels: Mamba-1's d_inner, Mamba-2's heads.  None keeps the layout
    by batch alone (a plain tensor, a model axis of 1 or one that does
    not divide them)."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return model_divides(x, din if s.version == 1 else din // s.head_p)


def _in_proj(cfg, p, x, j):
    """``x @ in_proj`` in its column blocks: (xi, z) for Mamba-1, (z, xi,
    Bc, Cc, dt) for Mamba-2.  With ``j`` (``_channels``) each rank
    multiplies by its own d_inner columns of the xi and z blocks and its
    own heads' columns of Mamba-2's dt, so that they come out split on
    their last dimension over the model axis: ``in_proj`` is replicated
    there, so each is a local slice with no collective
    (``split_locally``).  Mamba-2's B and C stay whole on every rank:
    every head reads them."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    if j is None:
        out = matmul(x, p.in_proj)
        if s.version == 1:
            return out.split([din, din], dim=-1)
        return _split_m2(cfg, out)
    w = p.in_proj
    # the first two blocks as (d, 2, din), split on din: no rank's columns
    # mix the two
    pair = split_locally(w[:, :2 * din].reshape(w.shape[0], 2, din), 2, j)
    first, second = matmul(x, pair[:, 0]), matmul(x, pair[:, 1])
    if s.version == 1:
        return first, second
    N = s.d_state
    Bc, Cc = matmul(x, w[:, 2 * din:2 * din + 2 * N]).split([N, N], dim=-1)
    dt = matmul(x, split_locally(w[:, 2 * din + 2 * N:], 1, j))
    return first, second, Bc, Cc, dt


def _out_proj(p, y, j):
    """``y @ out_proj``, a Partial sum over the model axis where ``y``
    holds each rank's own channels (``j``, ``_channels``); its gradient
    comes back Replicate on the model axis (``grad_replicated``), so
    that the mixer's backward runs on each rank's own channels too."""
    out = matmul(y, p.out_proj)
    return out if j is None else grad_replicated(out, j)


def _conv(x, w, b, state=None):
    """``_causal_conv`` on local shards.  x: (B, S, C)."""
    return on_local_shards(_causal_conv, (x, w, b, state),
                           (_BSC, {"chan": 1}, {"chan": 0}, _BSC),
                           {"batch": x.shape[0], "chan": x.shape[2]},
                           (_BSC, _BSC))


def _step_conv(new, w, b, state):
    """``_decode_conv`` on local shards.  new: (B, C)."""
    return on_local_shards(
        _decode_conv, (new, w, b, state),
        ({"batch": 0, "chan": 1}, {"chan": 1}, {"chan": 0}, _BSC),
        {"batch": new.shape[0], "chan": new.shape[1]},
        ({"batch": 0, "chan": 1}, _BSC))


def _local_scan(a, b, h0, dim):
    """``_chunked_assoc_scan`` on local shards, split by batch and by
    ``b``'s channel dimension ``dim`` (Mamba-1's d_inner, Mamba-2's
    heads)."""
    d, d0 = {"batch": 0, "chan": dim}, {"batch": 0, "chan": dim - 1}
    return on_local_shards(_chunked_assoc_scan, (a, b, h0), (d, d, d0),
                           {"batch": b.shape[0], "chan": b.shape[dim]},
                           (d, d0))


def _gated_rms_norm(y, z, w, dtype, j=None):
    """Mamba-2's gated RMSNorm: y * silu(z), normalized in float32.  With
    ``j`` (``_channels``) each rank holds its own heads' channels: the
    mean is a sum across the model axis, and its gradient, a Partial sum
    there, is reduced before it spreads back over the channels
    (``grad_replicated``; DTensor would split it by batch instead)."""
    y = y * F.silu(z)
    y32 = y.to(torch.float32)
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    if j is not None:
        var = grad_replicated(var, j)
    return (y32 * torch.rsqrt(var + RMS_EPS)).to(dtype) * w


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------


def mamba1_dt_bias(din: int) -> np.ndarray:
    """The reference's fixed ``dt_bias`` (float64; cast by the caller)."""
    u = np.random.default_rng(0).uniform(1e-3, 0.1, din)
    return np.log(np.expm1(np.clip(u, 1e-4, None)))


class Mamba1(nn.Module):
    """``in_proj`` (d, 2 din), ``conv_w`` (K, din), ``conv_b``, ``x_proj``
    (din, dt_rank + 2N), ``dt_proj`` (dt_rank, din), ``dt_bias``,
    ``A_log`` (din, N) and ``D`` (float32), ``out_proj`` (din, d): the
    reference's ``init_mamba1``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        s, d = cfg.ssm, cfg.d_model
        din, dtr = s.expand * d, s.dt_rank or d // 16
        dt = dtype_of(cfg.dtype)
        kw = dict(dtype=dt, device=device)
        self.in_proj = nn.Parameter(torch.empty(d, 2 * din, **kw))
        self.conv_w = nn.Parameter(torch.empty(s.d_conv, din, **kw))
        self.conv_b = nn.Parameter(torch.zeros(din, **kw))
        self.x_proj = nn.Parameter(torch.empty(din, dtr + 2 * s.d_state, **kw))
        self.dt_proj = nn.Parameter(torch.empty(dtr, din, **kw))
        self.dt_bias = nn.Parameter(
            torch.from_numpy(mamba1_dt_bias(din)).to(**kw))
        a_log = np.log(np.tile(np.arange(1, s.d_state + 1, dtype=np.float32),
                               (din, 1)))
        self.A_log = nn.Parameter(torch.from_numpy(a_log).to(device))
        self.D = nn.Parameter(torch.ones(din, dtype=torch.float32,
                                         device=device))
        self.out_proj = nn.Parameter(torch.empty(din, d, **kw))

    def forward(self, x, state=None):
        return mamba1_block(self.cfg, self, x, state=state)


def _mamba1_proj(cfg, p, xi):
    """x_proj, then dt (float32 after softplus), B and C."""
    s = cfg.ssm
    dtr = s.dt_rank or cfg.d_model // 16
    # on DTensors the row-sharded product's Partial sum is reduced here
    proj = batch_only(matmul(xi, p.x_proj))
    dt_in, Bc, Cc = proj.split([dtr, s.d_state, s.d_state], dim=-1)
    dt = softplus(matmul(dt_in, p.dt_proj) + p.dt_bias).to(torch.float32)
    return dt, Bc, Cc


def mamba1_block(cfg, p: Mamba1, x, *, state=None):
    """x: (B, S, d).  state: None (train/prefill) or dict {conv, ssm} to
    continue from.  Returns (y, {"conv", "ssm"}: the final states).  A
    DTensor ``x`` enters sharded on its batch alone (``batch_only``);
    where the model axis divides d_inner each rank then runs its own
    d_inner channels, and ``out_proj``'s output is a Partial sum over the
    model axis."""
    x = batch_only(x)
    j = _channels(cfg, x)
    xi, z = _in_proj(cfg, p, x, j)
    conv_state = None if state is None else state["conv"]
    xi, new_conv = _conv(xi, p.conv_w, p.conv_b, conv_state)
    xi = F.silu(xi)
    dt, Bc, Cc = _mamba1_proj(cfg, p, xi)
    A = -torch.exp(p.A_log)  # (din, N)

    xf = xi.to(torch.float32)
    Bf = Bc.to(torch.float32)
    Cf = Cc.to(torch.float32)
    a = torch.exp(dt[..., None] * A[None, None])  # (B, S, din, N)
    bterm = (dt * xf)[..., None] * Bf[:, :, None, :]
    h0 = None if state is None else state["ssm"]  # (B, din, N)
    h, last = _local_scan(a, bterm, h0, 2)
    y = torch.einsum("bsdn,bsn->bsd", h, Cf) + p.D * xf
    y = y.to(x.dtype) * F.silu(z)
    return _out_proj(p, y, j), {"conv": new_conv, "ssm": last}


def mamba1_decode(cfg, p: Mamba1, x, state):
    """Single-token decode, O(1): x (B, 1, d).  Returns (out, new_state).
    DTensors are laid out as in ``mamba1_block``."""
    x = batch_only(x)
    xi, z = _in_proj(cfg, p, x[:, 0], _channels(cfg, x))
    y, new_conv = _step_conv(xi, p.conv_w, p.conv_b, state["conv"])
    xi = F.silu(y)
    dt, Bc, Cc = _mamba1_proj(cfg, p, xi)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt[..., None] * A[None])  # (B, din, N)
    xf = xi.to(torch.float32)
    b = (dt * xf)[..., None] * Bc.to(torch.float32)[:, None, :]
    h = a * state["ssm"] + b
    yv = torch.einsum("bdn,bn->bd", h, Cc.to(torch.float32)) + p.D * xf
    out = matmul(yv.to(x.dtype) * F.silu(z), p.out_proj)
    return out[:, None], {"conv": new_conv, "ssm": h}


def mamba1_state_init(cfg, batch, dtype, *, device=None):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, din), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, din, s.d_state), dtype=torch.float32,
                           device=device),
    }


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, scalar decay per head)
# ---------------------------------------------------------------------------


class Mamba2(nn.Module):
    """``in_proj`` (d, 2 din + 2N + nh: [z, x, B, C, dt]), ``conv_w`` (K,
    din + 2N), ``conv_b``, ``A_log``, ``dt_bias`` and ``D`` (nh, float32),
    ``norm_w`` (din), ``out_proj`` (din, d): the reference's
    ``init_mamba2``."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        s, d = cfg.ssm, cfg.d_model
        din = s.expand * d
        nh = din // s.head_p
        kw = dict(dtype=dtype_of(cfg.dtype), device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = nn.Parameter(
            torch.empty(d, 2 * din + 2 * s.d_state + nh, **kw))
        self.conv_w = nn.Parameter(torch.empty(s.d_conv, din + 2 * s.d_state,
                                               **kw))
        self.conv_b = nn.Parameter(torch.zeros(din + 2 * s.d_state, **kw))
        self.A_log = nn.Parameter(torch.from_numpy(
            np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)).to(device))
        self.dt_bias = nn.Parameter(torch.zeros(nh, **f32))
        self.D = nn.Parameter(torch.ones(nh, **f32))
        self.norm_w = nn.Parameter(torch.ones(din, **kw))
        self.out_proj = nn.Parameter(torch.empty(din, d, **kw))

    def forward(self, x, state=None):
        return mamba2_block(self.cfg, self, x, state=state)


def _split_m2(cfg, fused):
    """[z, x, B, C, dt] of the fused ``in_proj`` product."""
    s = cfg.ssm
    din = s.expand * cfg.d_model
    return fused.split([din, din, s.d_state, s.d_state, din // s.head_p],
                       dim=-1)


def _conv_by_heads(conv, cfg, p, xi, Bc, Cc, state):
    """Mamba-2's conv and its silu, x apart from B and C: where each rank
    holds its own heads of ``xi`` and all of B and C.  ``conv_w``,
    ``conv_b`` and the conv state are split contiguously over din + 2N,
    which does not line up with the heads: they are gathered once a call
    (``whole_dim``), and each rank convolves its own x channels and all
    of B's and C's (``conv``: ``_conv`` or ``_step_conv``).  The conv is
    depthwise and silu elementwise, so a plain tensor's channels take the
    same operations as over [x, B, C] at once.  Returns (xi, Bc, Cc, the
    new conv state), the state whole on the model axis (a cache write
    lays it out as the cache, ``local_write``)."""
    N, din = cfg.ssm.d_state, xi.shape[-1]
    w, b = whole_dim(p.conv_w, 1), whole_dim(p.conv_b, 0)
    st_x = st_bc = None
    if state is not None:
        state = whole_dim(state, -1)
        st_x, st_bc = state[..., :din], state[..., din:]
    xi, new_x = conv(xi, w[:, :din], b[:din], st_x)
    bc, new_bc = conv(torch.cat([Bc, Cc], dim=-1), w[:, din:], b[din:],
                      st_bc)
    Bc, Cc = F.silu(bc).split([N, N], dim=-1)
    return F.silu(xi), Bc, Cc, torch.cat([new_x, new_bc], dim=-1)


def mamba2_block(cfg, p: Mamba2, x, *, state=None):
    """SSD with scalar-per-head decay. x: (B, S, d).  The chunked matmul
    form where the reference takes it (``S % SSD_CHUNK == 0`` and ``S >
    SSD_CHUNK``), else the associative scan over the (B, S, nh, hp, N)
    state.  Returns (y, {"conv", "ssm"}).  A DTensor ``x`` enters sharded
    on its batch alone (``batch_only``); where the model axis divides the
    heads each rank then runs its own heads (B and C whole), and
    ``out_proj``'s output is a Partial sum over the model axis."""
    s = cfg.ssm
    B, S, _ = x.shape
    din = s.expand * cfg.d_model
    nh = din // s.head_p
    x = batch_only(x)
    j = _channels(cfg, x)
    z, xi, Bc, Cc, dtr = _in_proj(cfg, p, x, j)
    conv_state = None if state is None else state["conv"]
    xi, Bc, Cc, new_conv = _conv_by_heads(_conv, cfg, p, xi, Bc, Cc,
                                          conv_state)

    dt = softplus(dtr.to(torch.float32) + p.dt_bias)  # (B, S, nh)
    A = -torch.exp(p.A_log)  # (nh,)
    xh = xi.reshape(B, S, nh, s.head_p)
    h0 = None if state is None else state["ssm"]
    if S % SSD_CHUNK == 0 and S > SSD_CHUNK:
        y, last = _ssd_chunked(dt, A, xh, Bc, Cc, h0, SSD_CHUNK)
    else:
        xf = xh.to(torch.float32)
        a = torch.exp(dt * A)  # (B, S, nh)
        bterm = (dt[..., None] * xf)[..., None] \
            * Bc.to(torch.float32)[:, :, None, None, :]
        h, last = _local_scan(a[..., None, None], bterm, h0, 2)
        y = torch.einsum("bshpn,bsn->bshp", h, Cc.to(torch.float32))
    y = (y.to(x.dtype) + p.D.to(x.dtype)[None, None, :, None]
         * xh.to(x.dtype))
    y = _gated_rms_norm(y.reshape(B, S, din), z, p.norm_w, x.dtype, j)
    return _out_proj(p, y, j), {"conv": new_conv, "ssm": last}


def _einsum_f32(eq, *ops):
    """``jnp.einsum(..., preferred_element_type=float32)`` over bfloat16
    operands: the operands widened exactly, summed in float32."""
    return torch.einsum(eq, *(t.to(torch.float32) for t in ops))


def _ssd_chunked(dt, A, xh, Bc, Cc, h0, Q):
    """Matmul-form SSD (Mamba-2 identity), per-head scalar decay.

    dt (B,S,nh), A (nh,), xh (B,S,nh,hp), Bc/Cc (B,S,N).  Within a chunk a
    decay-masked (Q,Q) matmul in bfloat16 (float32 accumulation), across
    chunks a float32 state recurrence.  Returns (y bfloat16, last
    state float32).  DTensors run on each rank's local shards
    (``dist.sharding.on_local_shards``), split by batch and by heads as
    they arrive (``dt`` and ``A`` by heads where the model axis splits
    ``dt_bias`` and ``A_log``); plain tensors run ``_ssd``."""
    bh = {"batch": 0, "heads": 2}
    return on_local_shards(
        _ssd, (dt, A, xh, Bc, Cc, h0),
        (bh, {"heads": 0}, bh, {"batch": 0}, {"batch": 0},
         {"batch": 0, "heads": 1}),
        {"batch": dt.shape[0], "heads": dt.shape[2]},
        (bh, {"batch": 0, "heads": 1}), Q=Q)


def _ssd(dt, A, xh, Bc, Cc, h0, *, Q):
    """``_ssd_chunked`` on plain tensors."""
    B, S, nh = dt.shape
    hp, N = xh.shape[-1], Bc.shape[-1]
    nc = S // Q
    cdt = torch.bfloat16  # the reference's intra-chunk compute dtype

    def r(t):
        return t.reshape((B, nc, Q) + tuple(t.shape[2:]))

    dtc, xc = r(dt), r(xh).to(cdt)  # (B,nc,Q,nh), (B,nc,Q,nh,hp)
    Bcc, Ccc = r(Bc).to(cdt), r(Cc).to(cdt)  # (B,nc,Q,N)
    loga = dtc * A  # (B,nc,Q,nh), <= 0, float32
    l = torch.cumsum(loga, dim=2)  # inclusive cumulative log-decay

    # intra-chunk: M[q,s] = G[q,s] * exp(l_q - l_s) * dt_s for s <= q
    G = _einsum_f32("bcqn,bcsn->bcqs", Ccc, Bcc).to(cdt)  # (B,nc,Q,Q)
    dl = l[:, :, :, None, :] - l[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.float32,
                                   device=dt.device))
    decay = (torch.exp(torch.clamp_max(dl, 0.0))
             * causal[None, None, :, :, None]).to(cdt)
    M = G[..., None] * decay * dtc[:, :, None, :, :].to(cdt)  # fold dt_s
    y_intra = _einsum_f32("bcqsh,bcshp->bcqhp", M, xc)

    # chunk states: S_c = sum_s exp(l_last - l_s) dt_s (x_s (x) B_s)
    w = (torch.exp(l[:, :, -1:, :] - l) * dtc).to(cdt)  # (B,nc,Q,nh)
    Sc = _einsum_f32("bcqh,bcqhp,bcqn->bchpn", w, xc, Bcc)  # (B,nc,nh,hp,N)
    chunk_decay = torch.exp(l[:, :, -1, :])  # (B,nc,nh)

    h = torch.zeros((B, nh, hp, N), dtype=torch.float32, device=dt.device) \
        if h0 is None else h0
    h_prev = []
    for c in range(nc):  # emit the state *entering* each chunk
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + Sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B,nc,nh,hp,N)

    # inter-chunk: y_q += exp(l_q) * C_q^T h_prev
    y_inter = _einsum_f32("bcqn,bchpn->bcqhp", Ccc, h_prev.to(cdt)) \
        * torch.exp(l)[..., None]
    y = (y_intra + y_inter).to(cdt).reshape(B, S, nh, hp)
    return y, h


def mamba2_decode(cfg, p: Mamba2, x, state):
    """Single-token decode: x (B, 1, d).  Returns (out, new_state).
    DTensors are laid out as in ``mamba2_block``."""
    s = cfg.ssm
    B = x.shape[0]
    din = s.expand * cfg.d_model
    nh = din // s.head_p
    x = batch_only(x)
    j = _channels(cfg, x)
    z, xi, Bc, Cc, dtr = _in_proj(cfg, p, x[:, 0], j)
    xi, Bc, Cc, new_conv = _conv_by_heads(_step_conv, cfg, p, xi, Bc, Cc,
                                          state["conv"])
    dt = softplus(dtr.to(torch.float32) + p.dt_bias)  # (B, nh)
    A = -torch.exp(p.A_log)
    xh = xi.reshape(B, nh, s.head_p).to(torch.float32)
    a = torch.exp(dt * A)[..., None, None]  # (B, nh, 1, 1)
    b = (dt[..., None] * xh)[..., None] \
        * Bc.to(torch.float32)[:, None, None, :]
    h = a * state["ssm"] + b
    yv = torch.einsum("bhpn,bn->bhp", h, Cc.to(torch.float32))
    yv = yv + p.D[None, :, None] * xh
    y = _gated_rms_norm(yv.reshape(B, din).to(x.dtype), z, p.norm_w,
                        x.dtype)
    return matmul(y, p.out_proj)[:, None], {"conv": new_conv, "ssm": h}


def mamba2_state_init(cfg, batch, dtype, *, device=None):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_p
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, din + 2 * s.d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.head_p, s.d_state),
                           dtype=torch.float32, device=device),
    }


# -- dispatch by ``cfg.ssm.version`` ------------------------------------------


def mixer(cfg, *, device=None) -> nn.Module:
    return (Mamba1 if cfg.ssm.version == 1 else Mamba2)(cfg, device=device)


def block_fn(cfg):
    return mamba1_block if cfg.ssm.version == 1 else mamba2_block


def decode_fn(cfg):
    return mamba1_decode if cfg.ssm.version == 1 else mamba2_decode


def state_init(cfg, batch, dtype, *, device=None):
    init = mamba1_state_init if cfg.ssm.version == 1 else mamba2_state_init
    return init(cfg, batch, dtype, device=device)
