"""PCRD-opt rate control (T.800 informative Annex J.10); counterpart of
grok_tpu/t2/rate_control.py, line for line.

Inputs are the batched T1 outputs: per-codeblock cumulative pass rates
[N, P] and per-pass distortion decreases [N, P], already weighted by
(step * band norm * MCT weight)^2 by the caller. The convex hull of each
codeblock's rate-distortion curve gives every pass an effective slope;
the layer search is host arithmetic on those slopes, as in the reference.

``hull_slopes`` is where the hull runs: on a CUDA tensor through K-q
``hull_slopes`` (csrc/hull.cu, the port of native/pipeline.cpp:630
hull_slopes, the host C++ the reference's default path runs), on a CPU
tensor through its plain version, the loop of ``hull_effective_slopes``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

HULL_MAX_PASSES = 256  # MAX_PASSES of csrc/hull.cu

# The inverse colour transforms in float64, rows (R, G, B) x columns
# (Y, Cb, Cr): the ICT's (grok_tpu/ops/mct.py _ICT_INV) and the RCT's
# linearised (grok_tpu/tile/tile_processor.py:876). The L2 norm of a column
# is how far an error in that component spreads into the image: the MCT
# weight of its distortions. (The transform kernels use the ICT in float32,
# ops/transform.py ICT_INV; weights from those would differ in the last
# bits, and PCRD compares slopes.)
ICT_INV64 = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]])
RCT_INV_LINEAR = np.array([[1.0, -0.25, 0.75], [1.0, -0.25, -0.25], [1.0, 0.75, -0.25]])


def mct_column_weights(m: np.ndarray) -> list[float]:
    """The L2 norm of each column of an inverse MCT matrix, as grok_tpu's
    _mct_weights (tile/tile_processor.py:866) computes it."""
    return [float(np.linalg.norm(m[:, j])) for j in range(m.shape[1])]


def hull_effective_slopes(rates: np.ndarray, dists: np.ndarray, npasses: np.ndarray):
    """Per-pass effective R-D slope after convex-hull pruning (the plain
    version of K-q).

    Returns slopes [N, P]: for each pass, the slope of the hull segment that
    covers it (non-increasing along each row); 0 beyond npasses. Including
    "all passes with eff_slope >= lambda" yields exactly the hull-feasible
    truncation for threshold lambda.
    """
    n, pmax = rates.shape
    slopes = np.zeros((n, pmax), dtype=np.float64)
    for i in range(n):
        np_i = int(npasses[i])
        if np_i == 0:
            continue
        r = rates[i, :np_i].astype(np.float64)
        d_cum = np.cumsum(dists[i, :np_i])

        def R(j):
            return r[j] if j >= 0 else 0.0

        def D(j):
            return d_cum[j] if j >= 0 else 0.0

        hull: list[int] = []
        for k in range(np_i):
            if d_cum[k] <= D(hull[-1] if hull else -1):
                continue  # adds no distortion reduction: never a vertex
            while hull:
                prev = hull[-2] if len(hull) >= 2 else -1
                s_top = (D(hull[-1]) - D(prev)) / max(R(hull[-1]) - R(prev), 1e-9)
                s_new = (d_cum[k] - D(prev)) / max(r[k] - R(prev), 1e-9)
                if s_new >= s_top:
                    hull.pop()
                else:
                    break
            hull.append(k)

        prev_idx = -1
        r0 = d0 = 0.0
        for h in hull:
            seg_slope = (d_cum[h] - d0) / max(r[h] - r0, 1e-9)
            slopes[i, prev_idx + 1 : h + 1] = seg_slope
            r0, d0 = r[h], d_cum[h]
            prev_idx = h
        # passes after the last vertex keep slope 0 (never included)
    return slopes


def hull_slopes(rates: torch.Tensor, dists: torch.Tensor,
                npasses: torch.Tensor) -> torch.Tensor:
    """Effective slopes float64 [n, P] of the device holding the inputs:
    rates int64 [n, P] (monotone, repaired), dists float64 [n, P] (weighted),
    npasses int32 [n], each contiguous. K-q on a CUDA tensor; the plain
    loop on a CPU tensor."""
    dev = rates.device
    n, p = rates.shape
    for t, name, dtype, shape in ((rates, "rates", torch.int64, (n, p)),
                                  (dists, "dists", torch.float64, (n, p)),
                                  (npasses, "npasses", torch.int32, (n,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: want {dtype} {list(shape)} on {dev}, got "
                             f"{t.dtype} {list(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return torch.from_numpy(hull_effective_slopes(rates.numpy(), dists.numpy(),
                                                      npasses.numpy()))
    if dev.type != "cuda":
        raise ValueError(f"hull_slopes: unsupported device {dev}")
    if p > HULL_MAX_PASSES:
        raise ValueError(f"hull_slopes: at most {HULL_MAX_PASSES} passes a codeblock")
    slopes = torch.empty((n, p), dtype=torch.float64, device=dev)
    if n:
        kernels.KERNELS["hull_slopes"].call(
            rates.data_ptr(), dists.data_ptr(), npasses.data_ptr(), slopes.data_ptr(), n, p,
            kernels.stream_ptr(dev))
    return slopes


def passes_for_threshold(slopes: np.ndarray, lam: float) -> np.ndarray:
    """Number of included passes per block for slope threshold lam."""
    return (slopes >= lam).sum(axis=1)


def dist_for_threshold(dists: np.ndarray, slopes: np.ndarray, lam: float) -> float:
    """Total distortion reduction captured by the passes above threshold."""
    return float(np.where(slopes >= lam, dists, 0.0).sum())


def rate_for_threshold(rates: np.ndarray, slopes: np.ndarray, lam: float) -> float:
    k = passes_for_threshold(slopes, lam)
    idx = np.maximum(k - 1, 0)
    r = np.take_along_axis(rates, idx[:, None], axis=1)[:, 0]
    return float(np.where(k > 0, r, 0).sum())


def allocate_layers(
    rates: np.ndarray,
    dists: np.ndarray,
    npasses: np.ndarray,
    layer_targets: list[float | None],
    header_overhead_fn=None,
    exact_rate_fn=None,
    dist_targets: list[float | None] | None = None,
    lam_out: list | None = None,
    *,
    slopes: np.ndarray,
) -> np.ndarray:
    """Compute per-block cumulative pass counts per layer.

    layer_targets: cumulative byte budgets per layer (None = include all).
    header_overhead_fn(cum_passes [N]) -> estimated packet-header bytes
    (heuristic path). exact_rate_fn(cum_rows list of [N]) -> exact
    cumulative stream bytes via full packet simulation, used instead of
    the heuristic when given. dist_targets: per-layer residual-distortion
    ceilings (PSNR layers). lam_out: when a list is passed, the accepted
    slope threshold of each layer is appended. slopes: the hull slopes
    [N, P] of (rates, dists, npasses), from ``hull_slopes``.
    Returns [L, N] cumulative pass counts (non-decreasing across layers).
    """
    n, pmax = rates.shape
    pos = slopes[slopes > 0]
    lo = float(pos.min()) if pos.size else 0.0
    hi = float(pos.max()) if pos.size else 1.0
    total_d = float(dists.sum())

    out = np.zeros((len(layer_targets), n), dtype=np.int64)
    prev = np.zeros(n, dtype=np.int64)
    prev_rows: list[np.ndarray] = []
    for li, target in enumerate(layer_targets):
        dtarget = dist_targets[li] if dist_targets else None
        lam_used = 0.0
        if target is None and dtarget is None:
            k = npasses.astype(np.int64)
        elif dtarget is not None:
            # fixed quality: smallest pass set with residual distortion
            # below the ceiling (largest feasible slope threshold)
            a = max(lo * 0.5, 1e-12)
            b = hi * 2.0 + 1.0
            for _ in range(64):
                mid = (a * b) ** 0.5
                if total_d - dist_for_threshold(dists, slopes, mid) <= dtarget:
                    a = mid
                else:
                    b = mid
            k = passes_for_threshold(slopes, a)
            lam_used = a
        elif exact_rate_fn is not None:
            # narrow with the cheap body-rate bisection, then find the exact
            # threshold with a bracketed geometric bisection on full packet
            # simulations
            a = max(lo * 0.5, 1e-12)
            b = hi * 2.0 + 1.0
            for _ in range(48):
                mid = (a * b) ** 0.5
                if rate_for_threshold(rates, slopes, mid) <= target * 0.99:
                    b = mid
                else:
                    a = mid
            lam = b
            k_b = np.maximum(passes_for_threshold(slopes, lam), prev)
            sims = 0
            lam_feas = lam_inf = None
            best_val = None
            v0 = exact_rate_fn(prev_rows + [k_b])
            if v0 <= target:
                lam_feas = lam
                best_val = v0
                # loosen to bracket: find an infeasible lower threshold
                cand = lam
                while sims < 4 and cand > lo * 0.5:
                    cand /= 1.6
                    k_c = np.maximum(passes_for_threshold(slopes, cand), prev)
                    sims += 1
                    vc = exact_rate_fn(prev_rows + [k_c])
                    if vc <= target:
                        lam_feas = cand
                        k_b = k_c
                        best_val = vc
                    else:
                        lam_inf = cand
                        break
            else:
                lam_inf = lam
                while sims < 12:
                    lam *= 1.6
                    k_c = np.maximum(passes_for_threshold(slopes, lam), prev)
                    sims += 1
                    vc = exact_rate_fn(prev_rows + [k_c])
                    if vc <= target:
                        lam_feas = lam
                        k_b = k_c
                        best_val = vc
                        break
                    lam_inf = lam
                if lam_feas is None:
                    k_b = prev.copy()  # nothing beyond earlier layers fits
            if lam_feas is not None and lam_inf is not None:
                # invariant: lam_inf < lam_feas (higher threshold = fewer
                # passes = feasible side)
                for _ in range(64):
                    # stop when within 1% of budget (or 64 bytes), the
                    # bracket has collapsed, or the sim budget is spent
                    close = best_val is not None and (
                        target - best_val <= max(64.0, 0.01 * target)
                    )
                    if close or lam_feas / lam_inf < 1.0000001 or sims >= 16:
                        break
                    mid = (lam_feas * lam_inf) ** 0.5
                    k_c = np.maximum(passes_for_threshold(slopes, mid), prev)
                    if (k_c == k_b).all():
                        lam_feas = mid  # same allocation: shrink, no sim
                        continue
                    sims += 1
                    vc = exact_rate_fn(prev_rows + [k_c])
                    if vc <= target:
                        lam_feas = mid
                        k_b = k_c
                        best_val = vc
                    else:
                        lam_inf = mid
            k = k_b
            lam_used = lam_feas if lam_feas is not None else float("inf")
        else:
            overhead = header_overhead_fn(prev) if header_overhead_fn else 0.0
            budget = max(target * 0.998 - overhead, 0.0)
            a, b = lo * 0.5, hi * 2.0 + 1.0
            # rate is non-increasing in lambda: bisect for the smallest
            # threshold whose rate fits the budget
            for _ in range(64):
                mid = 0.5 * (a + b)
                if rate_for_threshold(rates, slopes, mid) <= budget:
                    b = mid
                else:
                    a = mid
            k = passes_for_threshold(slopes, b)
            lam_used = b
        if lam_out is not None:
            lam_out.append(lam_used)
        k = np.maximum(k, prev)
        out[li] = k
        prev = k
        prev_rows.append(k)
    return out
