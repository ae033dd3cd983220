"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) in plain torch.

Counterpart of ``repro/models/ssm.py``.  The chunked SSD algorithm: within
a chunk the recurrence is a masked quadratic form (attention-like); across
chunks a linear state recurrence is scanned.

Shapes: x (B,S,H,P) heads x headdim;  dt (B,S,H) (post-softplus);  A (H,)
negative reals;  B_in/C_in (B,S,G,N) with H % G == 0;  D (H,).  Since A < 0
and dt > 0 every exponent below is <= 0, so f32 is safe.

Where the port departs from the reference (ROADMAP C1, DESIGN_TORCH.md §9):
the reference's ``ssd_scan`` loops over the chunks and dispatches the TACC op
``ssd_chunk`` per chunk, whose only registration is ``cpu``, so its Pallas
kernel (the op ``ssd_scan_kernel``) is never reached from the model.  The
port dispatches one level up.  :func:`ssd_scan` computes ``dt * A`` and its
within-chunk cumsum, then dispatches the TACC op ``ssd_scan``:

* ``cpu`` (the default): :func:`ssd_scan_chunks`, the reference's chunk loop
  over ``ssd_chunk`` (:func:`ssd_chunk_ref`);
* ``cuda``: ``kernels.ssd_scan.ssd_scan_model``, one launch of the SSD kernel
  for the whole sequence, which also returns the final state.

Both return (y f32 without the D*x term, final state f32); ``ssd_scan`` adds
D*x and casts to x's type after either, as the reference does.  Decode stays
plain torch on every device, as in the reference.
"""
from __future__ import annotations

import torch

import repro_torch.kernels  # noqa: F401  (registers the "cuda" ssd_scan variant)
from repro_torch.core import tacc


def _expand_groups(t, H):
    """(B,S,G,N) -> (B,S,H,N) by repeating each group H//G times."""
    return t.repeat_interleave(H // t.shape[2], dim=2)


@tacc.register("ssd_chunk", "cpu", default=True)
def ssd_chunk_ref(xc, dtc, ac, Bc, Cc):
    """One chunk's intra-chunk output + its state contribution.

    xc (B,Q,H,P), dtc (B,Q,H), ac (B,Q,H) = cumsum of dt*A within the chunk,
    Bc/Cc (B,Q,H,N).  Returns (y_intra (B,Q,H,P), state (B,H,N,P), decay
    (B,H) = exp(the chunk's total log-decay)), all f32.
    """
    af = ac.float()
    # L[i,j] = exp(a_i - a_j) for i >= j; the exponent is masked BEFORE the
    # exp: for i < j it is positive and can overflow
    diff = af[:, :, None] - af[:, None, :]                   # (B,Q,Q,H)
    Q = af.shape[1]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=af.device).tril()[None, :, :, None]
    L = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    scores = torch.einsum("bihn,bjhn->bijh", Cc.float(), Bc.float())
    xdt = xc.float() * dtc.float()[..., None]
    y_intra = torch.einsum("bijh,bjhp->bihp", scores * L, xdt)
    a_last = af[:, -1]                                        # (B,H)
    decay_to_end = torch.exp(a_last[:, None] - af)            # (B,Q,H)
    state = torch.einsum("bjhn,bjh,bjhp->bhnp", Bc.float(), decay_to_end, xdt)
    return y_intra, state, torch.exp(a_last)


@tacc.register("ssd_scan", "cpu", default=True)
def ssd_scan_chunks(x, dt, a_cum, B_in, C_in, chunk, init_state=None):
    """The reference's chunk loop (``repro/models/ssm.py:67-92``).  x
    (B,S,H,P), dt and a_cum (B,S,H) (a_cum the within-chunk cumsum of dt*A),
    B_in/C_in (B,S,G,N), S % chunk == 0 -> (y (B,S,H,P) f32 without D*x,
    final state (B,H,N,P) f32)."""
    B, S, H, P = x.shape
    N = B_in.shape[-1]
    nc = S // chunk

    def rs(t):
        return t.reshape(B, nc, chunk, *t.shape[2:])

    xc, dtc, ac = rs(x), rs(dt), rs(a_cum)
    Bc, Cc = rs(_expand_groups(B_in, H)), rs(_expand_groups(C_in, H))
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        y_intra, s_local, decay = tacc.dispatch("ssd_chunk", xc[:, c], dtc[:, c], ac[:, c],
                                                Bc[:, c], Cc[:, c])
        # inter-chunk: y_i += exp(a_i) * C_i . s_prev
        ein = torch.exp(ac[:, c].float())                     # (B,Q,H)
        y_inter = torch.einsum("bqhn,bhnp->bqhp", Cc[:, c].float(), s)
        ys.append(y_intra + y_inter * ein[..., None])
        s = decay[:, :, None, None] * s + s_local
    return torch.stack(ys, dim=1).reshape(B, S, H, P), s


def ssd_scan(x, dt, A, B_in, C_in, D, chunk: int, init_state=None):
    """Full SSD over the sequence.  Returns (y (B,S,H,P) in x.dtype,
    final_state (B,H,N,P) f32), the state after the last position (it seeds
    decoding after prefill).  ``chunk = min(chunk, S)`` and S must be a
    multiple of it, as in the reference."""
    B, S, H, P = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    dA = dt.float() * A.float()                               # (B,S,H), <= 0
    a_cum = torch.cumsum(dA.reshape(B, S // chunk, chunk, H), dim=2).reshape(B, S, H)
    y, final_state = tacc.dispatch("ssd_scan", x, dt, a_cum, B_in, C_in, chunk, init_state)
    y = y + x.float() * D.float()[:, None]
    return y.to(x.dtype), final_state


def ssd_decode_step(state, x, dt, A, B_in, C_in, D):
    """One-token recurrence.  x (B,1,H,P), state (B,H,N,P) -> (y, new_state)."""
    B, _, H, P = x.shape
    Bh = _expand_groups(B_in, H)[:, 0].float()                # (B,H,N)
    Ch = _expand_groups(C_in, H)[:, 0].float()
    dtf = dt.float()[:, 0]                                    # (B,H)
    xf = x.float()[:, 0]                                      # (B,H,P)
    decay = torch.exp(dtf * A.float())                        # (B,H)
    upd = torch.einsum("bhn,bhp->bhnp", Bh, xf * dtf[..., None])
    new_state = decay[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    y = y + xf * D.float()[None, :, None]
    return y[:, None].to(x.dtype), new_state


def ssd_reference(x, dt, A, B_in, C_in, D, init_state=None):
    """Sequential O(S) oracle: the plain recurrence, for tests."""
    B, S, H, P = x.shape
    N = B_in.shape[-1]
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        y, s = ssd_decode_step(s, x[:, t:t + 1], dt[:, t:t + 1], A,
                               B_in[:, t:t + 1], C_in[:, t:t + 1], D)
        ys.append(y)
    return torch.cat(ys, dim=1), s


# ---------------------------------------------------------------------------
# Causal depthwise conv (the short conv in the Mamba2 block)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w):
    """x (B,S,C), w (W,C) depthwise causal -> (B,S,C), f32 sums."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return out.to(x.dtype)


def conv_decode_step(conv_state, x_new, w):
    """conv_state (B,W-1,C), x_new (B,1,C) -> (y (B,1,C), new_state)."""
    window = torch.cat([conv_state, x_new], dim=1)            # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window.float(), w.float())[:, None]
    return y.to(x_new.dtype), window[:, 1:]
