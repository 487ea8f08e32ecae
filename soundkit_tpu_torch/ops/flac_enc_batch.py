"""Batched FLAC encode analysis (counterpart of
``soundkit_tpu/ops/flac_enc_batch.py``): the plan of one FLAC block for
every row, in one device call.

For each block the analysis builds the four candidate channels L, R,
S = L - R and M = (L + R) >> 1, picks the fixed predictor order 0-4 with
the least sum |residual|, fits an order-8 LPC (Welch-windowed float64
autocorrelation, Levinson-Durbin, coefficients quantized to precision
14), computes its exact integer residual, estimates the Rice cost of
both, and chooses fixed or LPC for each candidate and then the stereo
assignment. The host packer (``native_src/src/flac_pack.cpp``)
recomputes the chosen residuals from the plans and writes the frames.

- :func:`flac_analyze_plain` is the reference's ``flac_analyze_device``
  op for op in torch int64 / float64 (but the order of the
  autocorrelation's sums), the residual plane included (the
  tests and the CPU path use it);
- ``ops.flac_analyze.flac_analyze`` is K14: on CUDA tensors the kernel
  ``csrc/flac_analyze.cu``, on CPU tensors this module's plain version,
  both as packed ``[L, 23]`` int32 plan rows (:func:`flac_plans_pack`);
- :func:`flac_analyze_batch` is the numpy entry: one copy of the wire
  to the device, one call, one copy of the plan rows back.

Three departures from the reference; the streams stay valid and decode
to the same samples, and the plans differ only where noted:

- the autocorrelation is summed in K14's order (:func:`autocorrelation`),
  so that the card and the CPU give the same plans; the reference sums in
  XLA's order, and on a block the Levinson recursion is ill-conditioned
  for (a Welch-windowed tone) another order can move a coefficient;
- bit lengths are exact integers (``_clz64`` and the coefficients'
  ``log2`` there take the floor of a float64 ``log2``, which XLA's CPU
  backend rounds below the integer at 2^3, 2^6, 2^7, 2^12, 2^13, 2^14,
  2^24, 2^26, 2^28 and 2^48; where a Rice mean is exactly one of those,
  the reference's estimated parameter is one lower);
- the reference pads the number of rows to a power of two to bound
  XLA's compile cache; rows are independent, so the port analyzes the
  rows it is given.
"""
from __future__ import annotations

import numpy as np
import torch

LPC_ORDER = 8
LPC_PRECISION = 14
MAX_FIXED = 4

# stereo assignment codes (FLAC frame header) -> candidate-channel
# indices in the (L, R, S, M) stack
ASSIGN_CODES = (1, 8, 9, 10)           # LR, LS, RS, MS
ASSIGN_SLOTS = ((0, 1), (0, 2), (2, 1), (3, 2))

#: int32 columns of a packed plan row: assign, kind[2], order[2],
#: shift[2], qlp[2 x 8]
PLAN_COLS = 1 + 2 * 3 + 2 * LPC_ORDER
#: the LPC cost of a candidate whose fit is refused
NO_LPC_COST = 1 << 50

#: the order K14 sums the autocorrelation in, which the plain version
#: keeps (:func:`autocorrelation`): a thread's AC_SPT consecutive samples in
#: turn, the 32 lanes of a warp by a halving tree, the AC_WARPS warps of a
#: tile in turn, then the tiles in turn
AC_SPT = 16
AC_WARPS = 8
AC_TILE = AC_SPT * 32 * AC_WARPS


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values, exactly (0 for 0)."""
    n = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        big = (v >> s) > 0
        n = n + big * s
        v = torch.where(big, v >> s, v)
    return n + (v > 0)


def autocorrelation(xw: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Lags 0-8 of the windowed samples ``xw`` [..., N] float64 (zero from
    ``n_valid`` on), summed in K14's order (``AC_*``): every product and
    sum is rounded alone, so the CPU, the card's torch and K14 give the
    same bits. (The reference sums in XLA's order; a Welch-windowed tone
    is ill-conditioned enough that another order can move a quantized
    coefficient, so the port fixes one.)"""
    *lead, N = xw.shape
    tiles = -(-n_valid // AC_TILE)
    M = tiles * AC_TILE
    pad = torch.nn.functional.pad(xw, (LPC_ORDER, max(M - N, 0)))[..., : LPC_ORDER + M]
    p = torch.stack([pad[..., LPC_ORDER - lag: LPC_ORDER - lag + M] * pad[..., LPC_ORDER:]
                     for lag in range(LPC_ORDER + 1)], -2)       # [..., 9, M]
    p = p.reshape(*lead, LPC_ORDER + 1, tiles, AC_WARPS, 32, AC_SPT)
    s = torch.zeros(p.shape[:-1], dtype=xw.dtype, device=xw.device)
    for j in range(AC_SPT):
        s = s + p[..., j]
    lanes = 32
    while lanes > 1:
        lanes //= 2
        s = s[..., :lanes] + s[..., lanes: 2 * lanes]
    warps = s[..., 0]
    tile = warps[..., 0]
    for i in range(1, AC_WARPS):
        tile = tile + warps[..., i]
    acc = torch.zeros((*lead, LPC_ORDER + 1), dtype=xw.dtype, device=xw.device)
    for t in range(tiles):
        acc = acc + tile[..., t]
    return acc


def rice_est_cost(res: torch.Tensor, n_valid) -> torch.Tensor:
    """Estimated Rice cost of ``res`` [..., N] over its first ``n_valid``
    samples (the reference's ``_rice_est_cost``): k = max(bit_length(mean)
    - 2, 0) from the mean zigzag value, cost = sum(u >> k) + n (1 + k)."""
    u = (res << 1) ^ (res >> 63)                    # zigzag, int64
    tot = u.sum(-1)
    mean = torch.div(tot, torch.clamp(torch.as_tensor(n_valid, device=res.device), min=1),
                     rounding_mode="floor")
    k = torch.clamp(bit_length(mean) - 2, min=0)
    return (u >> k[..., None]).sum(-1) + n_valid * (1 + k)


def quantize_lpc(a: torch.Tensor):
    """(shift, qlp) of float64 coefficients ``a`` [..., 8] at precision 14
    (the reference's quantization): shift = clip(13 - floor(log2(max|a|)),
    0, 15) with an exact floor; NaN coefficients (a fit whose error went
    negative and then overflowed) quantize as the reference's conversion
    takes them: max|a| NaN gives shift 13, a NaN coefficient 0."""
    cmax = a.abs().amax(-1)
    nan = torch.isnan(cmax)
    _, e = torch.frexp(torch.where((cmax > 0) & torch.isfinite(cmax), cmax, 1.0))
    log2cmax = torch.where(nan, 0, torch.where(torch.isinf(cmax), 1 << 40, e.to(torch.int64)))
    shift = torch.clamp(LPC_PRECISION - log2cmax - 1, 0, 15)
    lim = 1 << (LPC_PRECISION - 1)
    scale = (torch.ones_like(shift) << shift).double()      # 2^shift, exactly
    q = torch.clamp(torch.round(a * scale[..., None]), -lim, lim - 1)
    return shift, torch.where(torch.isnan(q), 0.0, q).to(torch.int64)


def flac_analyze_plain(x: torch.Tensor, n_valid: int, bits: int, channels: int = 2):
    """Plan one FLAC block for every row, op for op the reference's
    ``flac_analyze_device`` (the autocorrelation summed in K14's order).

    x         [B, 2, N] integer samples (channel 1 zero for mono)
    n_valid   samples present (<= N, the same for every row)
    bits      declared bit depth
    channels  2 searches the stereo assignment; 1 (the reference's
              single-channel branch) plans candidate L alone: assign 0,
              both slots L

    Returns (assign [B], kind [B, 2], order [B, 2], shift [B, 2], qlp
    [B, 2, 8], res [B, 2, N]) as int32; res holds each slot's residual at
    [order:n_valid], zero elsewhere.
    """
    x = x.to(torch.int64)
    B, _, N = x.shape
    n_valid = int(n_valid)
    dev = x.device
    L, R = x[:, 0, :], x[:, 1, :]
    cand = torch.stack([L, R, L - R, (L + R) >> 1], dim=1)      # [B, 4, N]
    idx = torch.arange(N, device=dev)
    valid = idx < n_valid
    cand = torch.where(valid, cand, 0)

    # ---- fixed predictors 0..4: order by min sum|diff|, residual of the winner
    fixed_res, fixed_abs = [], []
    d = cand
    for o in range(MAX_FIXED + 1):
        if o:
            d = d[..., 1:] - d[..., :-1]
        r = torch.nn.functional.pad(d, (o, 0))
        r = torch.where((idx >= o) & valid, r, 0)
        fixed_res.append(r)
        fixed_abs.append(r.abs().sum(-1))
    fixed_order = torch.argmin(torch.stack(fixed_abs, -1), -1)   # [B, 4], first on a tie
    fres = fixed_res[0]
    for o in range(1, MAX_FIXED + 1):
        fres = torch.where((fixed_order == o)[..., None], fixed_res[o], fres)
    fcost = rice_est_cost(fres, n_valid - fixed_order) + fixed_order * bits + 8 + 6

    # ---- LPC order 8: Welch window autocorr + Levinson (f64)
    xf = cand.double()
    # divided by a tensor: torch on CUDA multiplies by the reciprocal of a
    # Python scalar divisor, which is not the correctly rounded quotient
    num = 2.0 * idx.double() - (n_valid - 1)
    t = num / torch.full_like(num, max(n_valid - 1, 1))
    w = torch.where(valid, 1.0 - t * t, 0.0)
    xw = xf * w
    ac = autocorrelation(xw, n_valid)                            # [B, 4, 9]

    a = torch.zeros((B, 4, LPC_ORDER), dtype=torch.float64, device=dev)
    err = ac[..., 0]
    ok = err > 0
    for i in range(LPC_ORDER):
        if i:
            s = a[..., i - 1] * ac[..., 1]            # sum(a reversed * ac[1:i+1]), in order
            for j in range(1, i):
                s = s + a[..., i - 1 - j] * ac[..., 1 + j]
            acc = ac[..., i + 1] - s
        else:
            acc = ac[..., 1]
        k = torch.where(ok & (err != 0), acc / torch.where(err != 0, err, 1.0), 0.0)
        new = a[..., :i] - k[..., None] * a[..., :i].flip(-1)
        a = torch.cat([new, k[..., None], a[..., i + 1:]], -1)
        err = err * (1.0 - k * k)
        ok = ok & (err > 0)
    shift, qlp = quantize_lpc(a)
    ok = ok & (qlp != 0).any(-1) & (n_valid > 2 * LPC_ORDER)

    # exact integer residual: pred[i] = sum_j qlp[j] * x[i-1-j], i >= 8
    pred = torch.zeros((B, 4, max(N - LPC_ORDER, 0)), dtype=torch.int64, device=dev)
    for j in range(LPC_ORDER):
        pred = pred + qlp[..., j:j + 1] * cand[..., LPC_ORDER - 1 - j: N - 1 - j]
    lres = cand[..., LPC_ORDER:] - (pred >> shift[..., None])
    lres = torch.nn.functional.pad(lres, (N - lres.shape[-1], 0))
    lres = torch.where((idx >= LPC_ORDER) & valid, lres, 0)
    lcost = rice_est_cost(lres, n_valid - LPC_ORDER) \
        + LPC_ORDER * bits + 8 + 6 + 4 + 5 + LPC_ORDER * LPC_PRECISION
    lcost = torch.where(ok, lcost, NO_LPC_COST)

    # ---- choose kind per candidate, then the stereo assignment
    kind = (lcost < fcost).to(torch.int64)              # [B, 4]
    ccost = torch.minimum(fcost, lcost)
    if channels == 2:
        combos = torch.stack([ccost[:, s0] + ccost[:, s1] for s0, s1 in ASSIGN_SLOTS], -1)
        best = torch.argmin(combos, -1)                  # [B], first on a tie
        assign = torch.tensor(ASSIGN_CODES, device=dev)[best]
        slots = torch.tensor(ASSIGN_SLOTS, device=dev)[best]  # [B, 2]
    else:
        assign = torch.zeros(B, dtype=torch.int64, device=dev)
        slots = torch.zeros((B, 2), dtype=torch.int64, device=dev)

    def pick(arr):
        return torch.gather(arr, 1, slots.reshape(B, 2, *([1] * (arr.ndim - 2)))
                            .expand(B, 2, *arr.shape[2:]))

    lpc = pick(kind).bool()
    res = torch.where(lpc[..., None], pick(lres), pick(fres))
    order = torch.where(lpc, LPC_ORDER, pick(fixed_order))
    return tuple(t.to(torch.int32) for t in
                 (assign, pick(kind), order, pick(shift), pick(qlp), res))


def flac_plans_pack(assign, kind, order, shift, qlp) -> torch.Tensor:
    """Plan tensors -> [L, 23] int32 rows: assign, kind[2], order[2],
    shift[2], qlp[2 x 8] (the layout :func:`flac_plans_unpack` reads)."""
    L = assign.shape[0]
    return torch.cat([assign[:, None], kind, order, shift, qlp.reshape(L, -1)],
                     -1).to(torch.int32)


def flac_plans_unpack(plans):
    """[L, 23] int32 plan rows -> (assign, kind, order, shift, qlp,
    None) in :func:`flac_analyze_x64`'s tuple layout."""
    L = plans.shape[0]
    return (
        plans[:, 0], plans[:, 1:3], plans[:, 3:5], plans[:, 5:7],
        np.ascontiguousarray(plans[:, 7:23]).reshape(L, 2, LPC_ORDER),
        None,
    )


def flac_analyze_batch(x: np.ndarray, n_valid: int, bits: int, *, channels: int = 2,
                       device="cuda"):
    """Serving entry: many independent blocks ``x`` [L, 2, N] (int16 for
    <= 16-bit streams, else int32) in one call on ``device``: the wire
    goes over once, K14 (``ops.flac_analyze.flac_analyze``) plans every
    row, and the packed rows come back once. Returns
    :func:`flac_plans_unpack`'s tuple."""
    from soundkit_tpu_torch.ops.flac_analyze import flac_analyze
    from soundkit_tpu_torch.utils.device import resolve_device

    wire = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    return flac_plans_unpack(flac_analyze(wire, n_valid, bits, channels).cpu().numpy())
