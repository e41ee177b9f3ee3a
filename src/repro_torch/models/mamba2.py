"""Mamba2 (SSD) blocks: the chunked-parallel training scan.  Counterpart of
``repro.models.mamba2`` (``ssd_reference``, ``_segsum``, ``ssd_chunked``,
``causal_conv``, ``_grouped_rmsnorm``, ``mamba_block_apply`` and the
block's parameter layout); the decode step and its cache belong to
serving and are not here.

State-space duality, chunked (Mamba2 paper §6): within a chunk of ``c``
steps the recurrence is a masked quadratic form; across chunks a Python
loop carries the ``(b, h, p, n)`` state.  Every decay is ``exp`` of a
difference of a running log-decay cumsum, so every ``exp`` argument is
<= 0, and the masked entries above the diagonal are ``exp(-inf) = 0``,
whose gradient is 0 (not NaN).  The per-chunk body runs under
``torch.utils.checkpoint`` when autograd records it, as the JAX package
puts ``jax.checkpoint`` on it: the ``(b, h, c, c)`` decay matrix exists
for one chunk at a time, in the forward and in the backward.  The scan
computes in fp32 whatever the input dtype.

The products are ``torch.matmul``/``einsum`` and the depthwise
convolution a shift-and-sum in the input's dtype, as in the JAX package
(``F.conv1d`` would add in another order and not match it in bf16): the
JAX package has no Pallas kernel here, so neither does the port.  The
scan and the convolution run inside the profiler ranges ``SSD`` and
``CONV``.

A block's parameters arrive as a dict keyed by their names under
``groups.mamba.`` (``"in_x.w"``, ``"A_log"``, ...), one block's slice of
the stacked leaves.  ``A_log``, ``D`` and ``dt_bias`` are fp32 whatever
the parameter dtype (``FP32_LEAVES``), as the JAX package draws them.

Tensor parallelism (``ctx.tp > 1``): the SSD heads are split over
``model`` in the head-major channel layout, so each rank's columns of
``in_x``/``in_z``/``in_dt``/``conv_x``/``norm`` and its entries of
``A_log``/``D``/``dt_bias`` are ``H / tp`` whole heads, and ``out`` is
row-parallel, between ``tp_copy`` and ``tp_reduce``.  The ``(2 N)``-wide
B/C projection and its conv kernel are replicated and read under
``tp_shared`` (each rank's gradient covers only its heads' use of them);
the gated norm is per head, so it needs no collective.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (ShardCtx, linear, maybe_tp_shared,
                                       rmsnorm, sp_shared, tp_copy,
                                       tp_reduce)

#: the block's leaves kept in fp32 whatever the parameter dtype
FP32_LEAVES = ("A_log", "D", "dt_bias")
#: the profiler ranges around the SSD scan and the causal convolution
SSD, CONV = "mamba.ssd", "mamba.conv"
#: the range ``dt`` is drawn from at init (log-uniform), as in JAX
DT_MIN, DT_MAX = 1e-3, 1e-1


def dims(cfg) -> tuple[int, int, int, int, int]:
    """(d_inner, SSD heads, head dim, state dim, conv width)."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return (d_inner, d_inner // sc.head_dim, sc.head_dim, sc.state_dim,
            sc.conv_dim)


def param_layout(cfg, lead: tuple[int, ...], prefix: str) -> list:
    """(name, shape, init) of one block's leaves in leaf order (sorted
    keys, uppercase first), each shape behind ``lead`` (the stacking
    dims).  ``init`` is a truncated-normal std, None for ones, or the
    name of a special draw: ``"a_log"`` (``log(linspace(1, 16, H))``) and
    ``"dt_bias"`` (``log(expm1(dt))``, ``dt`` log-uniform in [DT_MIN,
    DT_MAX])."""
    d = cfg.d_model
    d_inner, h, _, n, w = dims(cfg)
    leaves = [("A_log", (h,), "a_log"), ("D", (h,), None),
              ("conv_bc", (w, 2 * n), 1 / math.sqrt(w)),
              ("conv_x", (w, d_inner), 1 / math.sqrt(w)),
              ("dt_bias", (h,), "dt_bias"),
              ("in_bc", (d, 2 * n), 1 / math.sqrt(d)),
              ("in_dt", (d, h), 1 / math.sqrt(d)),
              ("in_x.w", (d, d_inner), 1 / math.sqrt(d)),
              ("in_z.w", (d, d_inner), 1 / math.sqrt(d)),
              ("ln", (d,), None), ("norm", (d_inner,), None),
              ("out.w", (d_inner, d), 1 / math.sqrt(d_inner))]
    return [(prefix + name, (*lead, *shape), init)
            for name, shape, init in leaves]


def a_log_init(n_heads: int) -> torch.Tensor:
    """``log(linspace(1, 16, n_heads))`` in fp32, computed in fp64 and
    rounded once."""
    return torch.log(torch.linspace(1.0, 16.0, n_heads,
                                    dtype=torch.float64)).float()


def dt_bias_init_(t: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """In place: the inverse softplus of ``dt``, ``dt`` log-uniform in
    [DT_MIN, DT_MAX] (one fp32 draw per element)."""
    with torch.no_grad():
        u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        u.uniform_(math.log(DT_MIN), math.log(DT_MAX), generator=generator)
        return t.copy_(torch.log(torch.expm1(torch.exp(u))))


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
def ssd_reference(x, dt, A, Bm, Cm, h0=None):
    """Sequential oracle.  x: (b,l,h,p); dt: (b,l,h); A: (h,) (negative);
    Bm, Cm: (b,l,n).  Returns (y (b,l,h,p), h_final (b,h,p,n)), fp32."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    x, dt, Bm, Cm, A = (t.float() for t in (x, dt, Bm, Cm, A))
    hs = x.new_zeros(b, h, p, n) if h0 is None else h0.float()
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * A)                     # (b,h)
        upd = (dt[:, t, :, None] * x[:, t])[..., None] \
            * Bm[:, t, None, None, :]
        hs = decay[..., None, None] * hs + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cm[:, t]))
    return torch.stack(ys, dim=1), hs


def _segsum(s: torch.Tensor) -> torch.Tensor:
    """s: (..., c) inclusive log-decay cumsum -> (..., c, c) matrix of
    s[t] - s[i] for i <= t, -inf above the diagonal."""
    c = s.shape[-1]
    diff = s[..., :, None] - s[..., None, :]
    mask = torch.ones(c, c, dtype=torch.bool, device=s.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _chunk_step(carry, xk, dtk, Bk, Ck, sk):
    """One chunk: carry (b,h,p,n); xk (b,c,h,p); dtk, sk (b,c,h); Bk, Ck
    (b,c,n).  Returns (the state after the chunk, the chunk's y)."""
    G = torch.einsum("btn,bin->bti", Ck, Bk)                # (b,c,c)
    L = torch.exp(_segsum(sk.transpose(1, 2)))              # (b,h,c,c)
    dx = dtk[..., None] * xk                                # (b,c,h,p)
    Yd = torch.einsum("bhti,bihp->bthp", G[:, None] * L, dx)
    Yi = torch.exp(sk)[..., None] * torch.einsum("bcn,bhpn->bchp", Ck,
                                                 carry)
    decay_out = torch.exp(sk[:, -1:, :] - sk)               # (b,c,h)
    states = torch.einsum("bchp,bcn->bhpn", decay_out[..., None] * dx, Bk)
    h_new = torch.exp(sk[:, -1, :])[..., None, None] * carry + states
    return h_new, Yd + Yi


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked-parallel SSD.  Shapes as ``ssd_reference``; fp32
    throughout.  ``l`` is padded up to a multiple of ``c = min(chunk,
    l)`` and the padding cut off the output."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    x, dt, Bm, Cm, A = (t.float() for t in (x, dt, Bm, Cm, A))
    c = min(chunk, l)
    pad = (-l) % c
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // c
    s = torch.cumsum(dt.reshape(b, nc, c, h) * A, dim=2)   # (b,nc,c,h) <= 0
    carry = x.new_zeros(b, h, p, n) if h0 is None else h0.float()
    remat = torch.is_grad_enabled()
    ys = []
    for k in range(nc):
        part = slice(k * c, (k + 1) * c)
        args = (carry, x[:, part], dt[:, part], Bm[:, part], Cm[:, part],
                s[:, k])
        carry, y = checkpoint(_chunk_step, *args, use_reentrant=False) \
            if remat else _chunk_step(*args)
        ys.append(y)
    y = ys[0] if nc == 1 else torch.cat(ys, dim=1)
    return y[:, :l], carry


# --------------------------------------------------------------------------
# causal depthwise convolution (shift-and-sum) and the gated norm
# --------------------------------------------------------------------------
def causal_conv(u: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """u: (b, l, ch); kernel: (w, ch).  Causal depthwise convolution, then
    SiLU, in ``u``'s dtype: ``sum(full[:, j:j+l] * kernel[j])`` over ``j``
    in order, ``full`` being ``u`` behind ``w - 1`` zero steps."""
    w, l = kernel.shape[0], u.shape[1]
    full = F.pad(u, (0, 0, w - 1, 0))
    k = kernel.to(u.dtype)
    y = sum(full[:, j:j + l] * k[j] for j in range(w))
    return F.silu(y)


def _grouped_rmsnorm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                     head_dim: int, eps: float) -> torch.Tensor:
    """Gated per-head RMSNorm: ``norm(y * silu(z))``, the gate in ``y``'s
    dtype, the per-head statistics in fp32."""
    g = y * F.silu(z)
    b, l, ch = g.shape
    gh = g.reshape(b, l, ch // head_dim, head_dim).float()
    var = (gh * gh).mean(dim=-1, keepdim=True)
    gh = gh * torch.rsqrt(var + eps)
    return (gh.reshape(b, l, ch) * scale.float()).to(y.dtype)


def mamba_block_apply(p: dict, x: torch.Tensor, cfg,
                      ctx: ShardCtx) -> torch.Tensor:
    """Pre-norm Mamba2 block.  x: (B, S, d) in the compute dtype (this
    rank's slice of the sequence under SP); returns ``x +
    mamba(norm(x))``, on this rank's ``H / tp`` heads under TP."""
    _, _, hd, n, _ = dims(cfg)
    h = rmsnorm(sp_shared(p["ln"], ctx), x, cfg.norm_eps)
    h = tp_copy(h, ctx)                          # the whole sequence
    b, s, _ = h.shape
    xs = linear(p["in_x.w"], h, ctx)                        # (B,S,d_in/tp)
    z = linear(p["in_z.w"], h, ctx)
    bc = linear(maybe_tp_shared(p["in_bc"], ctx), h, ctx)   # (B,S,2N)
    dt = F.softplus(linear(p["in_dt"], h, ctx).float()
                    + p["dt_bias"].float())                 # (B,S,H/tp)
    with record_function(CONV):
        xs = causal_conv(xs, p["conv_x"])
        bc = causal_conv(bc, maybe_tp_shared(p["conv_bc"], ctx))
    Bm, Cm = bc[..., :n], bc[..., n:]
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, s, -1, hd)
    with record_function(SSD):
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm.chunk)
    y = y + p["D"].float()[:, None] * xh.float()
    y = y.reshape(b, s, -1).to(ctx.compute_dtype)
    y = _grouped_rmsnorm(p["norm"], y, z, hd, cfg.norm_eps)
    return x + tp_reduce(linear(p["out.w"], y, ctx), ctx)
