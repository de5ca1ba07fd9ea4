"""Mamba-2 SSD (state-space duality, arXiv:2405.21060), chunked form (port
of ``repro.models.mamba``).

The SSD layer computes, per head h with scalar decay a_t = exp(Δ_t·A)
(A = −exp(A_log) < 0, Δ_t = softplus(dt_t + dt_bias)):
    y_t = Σ_{s≤t} (Π_{r=s+1..t} a_r) · (C_t·B_s) · Δ_s x_s  + D·x_t
which the chunked algorithm evaluates as an intra-chunk quadratic part
plus an inter-chunk recurrence over the chunk states: O(S·C), not O(S²).

Used by ``mamba2-130m`` and the Mamba sublayers of ``jamba-1.5-large``.
The reference computes the layer outside any Pallas kernel (einsums and a
``lax.scan`` over the chunks), so the port's is ``torch.einsum`` /
``matmul`` and a Python loop over the chunks.

Where the port and the reference differ:
- ``F.softplus`` returns x itself above its threshold of 20, where
  ``jax.nn.softplus`` is ``logaddexp(x, 0)``; the two differ by less than
  2e-9 there.
- A three-operand einsum of the reference is two steps here (a broadcast
  product, then a two-operand einsum): the same sums in another order.
- ``torch.einsum`` refuses mixed dtypes where ``jnp.einsum`` promotes, so
  the decode step casts B and C (in x's dtype) to f32 before they meet
  the f32 Δ and state; bf16 → f32 is exact.
- ``ssd_chunked`` raises ``ValueError`` where the reference's ``assert``
  raises ``AssertionError``.
- ``ssd_decode_step`` writes the state in place and returns it.

Under a mesh (``axis``, the bound "model" axis; ``models.lm`` passes it
where ``train.shardings.param_specs`` splits ``x_proj``'s and
``z_proj``'s columns and ``out_proj``'s rows over it) a rank holds its
columns of d_inner; ``bc_proj``, ``dt_proj`` and the per-head vectors are
whole on every rank.  Where the heads divide the axis prefill runs the
scan over the rank's heads only (the
reference's docstring: no collective inside the scan), ``dt_proj``'s
output and ``A_log``, ``D`` and ``dt_bias`` cut to them; the gated
RMSNorm's sum of squares is summed over the axis in rank order
(``ssd.norm``) and divided by the whole d_inner.  Otherwise, and in every
decode step (``cache_specs`` keeps the SSM state whole on every model
rank), x's and z's columns are gathered in one call (``ssd.xz``,
``decode.ssd``) and every rank runs the whole layer alike, the state's
same bits on each.  Either way ``out_proj`` is row-parallel: the rank's
rows of the normalised y, the partial products summed over the axis in
rank order (``ssd.out``).  No gradient runs through these collectives
(``models.lm`` refuses one under a mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (Params, gather_cols, linear, linear_init, linear_rows,
                     rmsnorm, rmsnorm_init)

NEG_BIG = -1e30      # the reference's mask value for the upper triangle


def ssd_init(gen, d_model: int, d_inner: int, d_state: int, head_dim: int,
             dtype=torch.float32) -> Params:
    """The reference's tree: separate x/z/BC/dt projections (not a fused
    in_proj), ``out_proj``, and the per-head ``A_log`` (log of 1..16
    spaced evenly), ``D`` (ones), ``dt_bias`` (zeros) and the gated
    RMSNorm's ``norm``.  The matrices take ``dtype``; the vectors stay f32
    (the reference serves only its matrices in the compute type)."""
    n_heads = d_inner // head_dim
    dev = gen.device
    return {
        "x_proj": linear_init(gen, d_model, d_inner, dtype=dtype),
        "z_proj": linear_init(gen, d_model, d_inner, dtype=dtype),
        "bc_proj": linear_init(gen, d_model, 2 * d_state, dtype=dtype),
        "dt_proj": linear_init(gen, d_model, n_heads, dtype=dtype),
        "out_proj": linear_init(gen, d_inner, d_model, dtype=dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          dtype=torch.float32, device=dev)),
        "D": torch.ones(n_heads, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(n_heads, dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, dev),
    }


def ssd_param_count(d_model: int, d_inner: int, d_state: int,
                    head_dim: int) -> int:
    """Number of parameters of ``ssd_init``."""
    n_heads = d_inner // head_dim
    return (d_model * (2 * d_inner + 2 * d_state + n_heads)
            + d_inner * d_model + 3 * n_heads + d_inner)


def _project(p: Params, x, d_state: int):
    xi = linear(p["x_proj"], x)
    z = linear(p["z_proj"], x)
    bc = linear(p["bc_proj"], x)
    B, C = bc[..., :d_state], bc[..., d_state:]
    dt = linear(p["dt_proj"], x)
    return xi, z, B, C, dt


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 128):
    """Chunked SSD scan.  x: (b, S, H, dh); dt: (b, S, H) post-softplus;
    A: (H,) (negative); B, C: (b, S, N); D: (H,).  Returns (b, S, H, dh).
    S must be a multiple of ``chunk``."""
    b, S, H, dh = x.shape
    N = B.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"sequence must be divisible by chunk: S = {S}, "
                         f"chunk = {chunk}")
    xc = x.reshape(b, nc, chunk, H, dh)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = B.reshape(b, nc, chunk, N)
    Cc = C.reshape(b, nc, chunk, N)

    dA = dtc * A[None, None, None, :]          # (b,nc,c,H) log-decay ≤ 0
    cum = torch.cumsum(dA, dim=2)                   # within-chunk cumulative
    total = cum[:, :, -1, :]                        # (b,nc,H)

    # intra-chunk: decay(t, s) = exp(cum_t − cum_s) for s ≤ t.  Mask before
    # the exp: the upper triangle is positive and would overflow.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,t,s,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = seg.masked_fill_(~tri[None, None, :, :, None], NEG_BIG).exp_()
    scores = torch.einsum("bgtn,bgsn->bgts", Cc, Bc)      # (b,nc,t,s)
    w = scores[..., None] * decay                          # (b,nc,t,s,H)
    del seg, decay
    xin = xc * dtc[..., None]                              # Δ-weighted input
    y_intra = torch.einsum("bgtsh,bgshd->bgthd", w, xin)
    del w

    # chunk states: state_g = Σ_s exp(total_g − cum_s) · B_s ⊗ (Δ_s x_s)
    sdecay = torch.exp(total[:, :, None, :] - cum)         # (b,nc,c,H)
    state = torch.einsum("bgsn,bgshd->bghnd", Bc, xin * sdecay[..., None])

    # inter-chunk recurrence: the state carried into each chunk
    st = torch.zeros(b, H, N, dh, dtype=x.dtype, device=x.device)
    prev = []
    for g in range(nc):
        prev.append(st)
        st = st * torch.exp(total[:, g])[:, :, None, None] + state[:, g]
    prev_states = torch.stack(prev, 1)                     # (b,nc,H,N,dh)

    # the carried state's contribution: y_t += exp(cum_t) · C_t · st_prev
    y_inter = torch.einsum("bgtn,bghnd->bgthd", Cc, prev_states) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, S, H, dh)
    return y + x * D[None, None, :, None]


def ssd_reference(x, dt, A, B, C, D):
    """O(S) sequential oracle, one token a step (the tests')."""
    b, S, H, dh = x.shape
    N = B.shape[-1]
    st = torch.zeros(b, H, N, dh, dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[..., None, None]   # (b,H,1,1)
        st = st * decay + B[:, t, None, :, None] \
            * (dt[:, t, :, None] * x[:, t])[:, :, None, :]
        ys.append(torch.einsum("bn,bhnd->bhd", C[:, t], st))
    y = torch.stack(ys, 1)
    return y + x * D[None, None, :, None]


def _block(n: int, axis) -> slice:
    """This rank's block of n (heads or columns) split over ``axis``; the
    whole when ``axis`` is None."""
    if axis is None:
        return slice(0, n)
    m = n // axis.size
    return slice(axis.rank * m, (axis.rank + 1) * m)


def _gated_norm_out(p: Params, y, z, d_inner: int, axis, part):
    """``rmsnorm(y · silu(z))`` over the whole d_inner, then ``out_proj``.
    ``part`` (the axis y's and z's columns are split over, or None where
    they are whole): the mean of squares is the ranks' sums of squares
    summed in rank order over the whole d_inner, each rank scaling its
    columns.  ``axis``: ``out_proj``'s rows split over it (the rank's
    columns of a whole y are cut first); None on one device."""
    g = rmsnorm(p["norm"], y * F.silu(z), axis=part, site="ssd.norm")
    if axis is not None and part is None:
        g = g[..., _block(d_inner, axis)]
    return linear_rows(p["out_proj"], g, axis, site="ssd.out")


def ssd_apply(p: Params, x, *, d_inner: int, d_state: int, head_dim: int,
              chunk: int = 128, axis=None):
    """Full Mamba-2 block (no conv1d, as in the reference): in-projections
    → SSD in f32 → gated RMSNorm → out-projection.  x: (B, S, d_model).
    y is cast to x's dtype before the ``silu(z)`` gate and the norm, in the
    reference's order.  ``axis``: the mesh's split (module docstring)."""
    n_heads = d_inner // head_dim
    xi, z, B, C, dt = _project(p, x, d_state)
    part = axis if axis is not None and n_heads % axis.size == 0 else None
    if axis is not None and part is None:
        xi, z = gather_cols([xi, z], axis, site="ssd.xz", alike=True)
    hs = _block(n_heads, part)
    bsz, S, _ = xi.shape
    xi = xi.reshape(bsz, S, -1, head_dim)
    dt = F.softplus(dt[..., hs].to(torch.float32)
                    + p["dt_bias"][hs].to(torch.float32))
    A = -torch.exp(p["A_log"][hs].to(torch.float32))
    y = ssd_chunked(xi.to(torch.float32), dt, A, B.to(torch.float32),
                    C.to(torch.float32), p["D"][hs].to(torch.float32),
                    chunk=chunk)
    y = y.reshape(bsz, S, -1).to(x.dtype)
    return _gated_norm_out(p, y, z, d_inner, axis, part)


def ssd_decode_step(p: Params, x, state, *, d_inner: int, d_state: int,
                    head_dim: int, axis=None):
    """Single-token decode: x (B, 1, d_model), state (B, H, N, dh) f32,
    every head, written in place.  Returns (y (B, 1, d_model), state).
    Under a mesh (``axis``) x's and z's columns are gathered first and
    ``out_proj`` is row-parallel (module docstring)."""
    n_heads = d_inner // head_dim
    xi, z, B, C, dt = _project(p, x, d_state)
    if axis is not None:
        xi, z = gather_cols([xi, z], axis, site="decode.ssd", alike=True)
    bsz = xi.shape[0]
    xi = xi.reshape(bsz, n_heads, head_dim).to(torch.float32)
    B, C = B[:, 0].to(torch.float32), C[:, 0].to(torch.float32)
    dt = F.softplus(dt[:, 0].to(torch.float32)
                    + p["dt_bias"].to(torch.float32))          # (B, H)
    A = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dt * A)[..., None, None]
    state.mul_(decay).add_(B[:, None, :, None]
                           * (dt[..., None] * xi)[:, :, None, :])
    y = torch.einsum("bn,bhnd->bhd", C, state)
    y = y + xi * p["D"].to(torch.float32)[None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    return _gated_norm_out(p, y, z, d_inner, axis, None), state
