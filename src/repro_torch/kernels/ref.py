"""Plain PyTorch versions of the solver's hot-spot ops.

Each function mirrors the op of the same name in the JAX package's
``kernels/ref.py`` expression for expression.  They are the semantics the CUDA
kernels in ``csrc/`` must match, and the execution path for tensors that lie
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _weights(c, like):
    """Tableau weights (numpy or tensor) as a tensor in ``like``'s dtype and
    device, as the JAX ref casts them to the stages' dtype."""
    if isinstance(c, torch.Tensor):
        return c.to(dtype=like.dtype, device=like.device)
    return torch.tensor(np.ascontiguousarray(c), dtype=like.dtype, device=like.device)


def stage_accum(y, dt, K, coeffs):
    """y + dt * sum_j coeffs[j] * K[j].

    y:      (b, f)
    dt:     (b,)
    K:      (j, b, f)  -- stacked stage derivatives
    coeffs: (j,)       -- tableau row a[i, :j]
    """
    acc = torch.tensordot(_weights(coeffs, K), K, dims=1)
    return y + dt[:, None] * acc


def fused_update(y, K, dt, b_sol, b_err):
    """One fused pass producing the solution update and the embedded error.

    y1  = y + dt * (b_sol . K)
    err =     dt * (b_err . K)

    K: (s, b, f); b_sol, b_err: (s,).  Returns (y1, err), both (b, f).
    """
    b_sol, b_err = _weights(b_sol, K), _weights(b_err, K)
    y1 = y + dt[:, None] * torch.tensordot(b_sol, K, dims=1)
    err = dt[:, None] * torch.tensordot(b_err, K, dims=1)
    return y1, err


def broadcast_tolerances(atol, rtol, dtype, device=None):
    """Normalize tolerances onto column-broadcastable tensors.

    Accepted shapes: scalar (batch-shared), (b,) per-instance, or full (b, f).
    Returns (atol, rtol) ready to broadcast against a (b, f) state.
    ``device`` places Python scalars; tensors keep the device they are on.
    """
    atol = torch.as_tensor(atol, dtype=dtype, device=device)
    rtol = torch.as_tensor(rtol, dtype=dtype, device=device)
    if atol.ndim == 1:
        atol = atol[:, None]
    if rtol.ndim == 1:
        rtol = rtol[:, None]
    return atol, rtol


def error_norm(err, y0, y1, atol, rtol):
    """Weighted RMS norm, per instance.

    ||err / (atol + rtol * max(|y0|, |y1|))||_rms  over the feature axis.

    err, y0, y1: (b, f);  atol, rtol: scalar or (b,) or (b, f).
    Returns (b,).
    """
    atol, rtol = broadcast_tolerances(atol, rtol, err.dtype, err.device)
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    ratio = err / scale
    return torch.sqrt(torch.mean(ratio * ratio, dim=-1))


def rms_norm(x, scale):
    """Scaled RMS over the feature axis: ||x / scale||_rms.

    x, scale: (b, f) (scale may broadcast).  Returns (b,).
    """
    ratio = x / scale
    return torch.sqrt(torch.mean(ratio * ratio, dim=-1))


def hermite_coeffs(y0, y1, f0, f1, dt):
    """Cubic-Hermite dense-output coefficients in Horner form.

    p(x) = ((c3 * x + c2) * x + c1) * x + c0,  x = (t - t0)/dt in [0, 1].
    Returns (c0, c1, c2, c3), each (b, f).
    """
    hdt = dt[:, None]
    c0 = y0
    c1 = hdt * f0
    c2 = 3.0 * (y1 - y0) - hdt * (2.0 * f0 + f1)
    c3 = 2.0 * (y0 - y1) + hdt * (f0 + f1)
    return c0, c1, c2, c3


def batched_linsolve(A, rhs):
    """Batched dense linear solve: x s.t. A @ x = rhs, per instance.

    A:   (b, f, f) Newton matrices (I - dt*gamma*J -- well conditioned for
         any stable step size, diagonally dominant in the stiff limit)
    rhs: (b, f)

    Returns (b, f).  The inner hot spot of the masked-Newton layer.  It is
    ``batched_lu_factor`` followed by the substitution ``fused_newton_iter``
    runs (``_lu_solve_perm``), not ``torch.linalg.solve`` (another LAPACK
    path with its own rounding): so a chord-Newton iteration through this op
    and ``masked_newton_update`` equals one ``fused_newton_iter`` against the
    same factors bitwise, and fused DIRK solves equal unfused ones.
    """
    lu, perm = batched_lu_factor(A)
    return _lu_solve_perm(lu, perm, rhs)


LU_BATCHED_MAX_F = 128  # the widest batch factored in one LAPACK call


def batched_lu_factor(A):
    """Batched partial-pivoted LU factorization: factor ONCE per solver step.

    A: (b, f, f) chord matrices I - dt*gamma*J.

    Returns ``(lu, permutation)``: the packed LU factors (unit lower + upper
    triangle in one (b, f, f) tensor) and the (b, f) int32 row permutation
    with ``A[permutation] == L @ U`` -- a permutation, as ``lax.linalg.lu``
    returns it, not LAPACK's sequential row swaps.  A zero pivot is not an
    error: its column is left unscaled and the substitution divides by it.

    Above ``LU_BATCHED_MAX_F`` columns each matrix is factored on its own:
    PyTorch's CPU build (MKL getrf) factors a batch of two or more matrices
    from f = 151 on wrong once the process has set more than one thread
    ("Parameter 6 was incorrect on entry to SLASWP") and then never returns;
    one matrix at a time returns at every width.
    """
    if A.shape[-1] > LU_BATCHED_MAX_F and A.shape[0] > 1:
        parts = [torch.linalg.lu_factor_ex(A[i:i + 1]) for i in range(A.shape[0])]
        lu, pivots = torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    else:
        lu, pivots, _ = torch.linalg.lu_factor_ex(A)
    # A = P L U, so (P^T A)[i] = A[perm[i]] with P[perm[i], i] == 1.  P is
    # read off the pivots alone: unpacked from a copy of the factors with no
    # tangent, as ``lu_unpack``'s forward-mode rule is for the unpacked
    # factors, and under ``torch.func.jvp`` it fails on ``lu`` itself.
    P, _, _ = torch.lu_unpack(torch.zeros_like(lu), pivots, unpack_data=False)
    # LAPACK hands back column-major factors; the op's are row-major.
    return lu.contiguous(), P.argmax(dim=-2).to(torch.int32)


def _lu_solve_perm(lu, perm, g):
    """x with A x = g from ``batched_lu_factor(A) == (lu, perm)``: the row
    gather g[perm], then the unit-lower and the upper triangular solves, as
    ``lax.linalg``'s ``lu_solve`` runs them."""
    x = torch.gather(g, 1, perm.long())[..., None]
    x = torch.linalg.solve_triangular(lu, x, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(lu, x, upper=True)[..., 0]


def _masked_commit(k, delta, active, scale):
    """``where(active, k - delta, k)`` and the (b,) RMS of ``delta / scale``:
    the tail both Newton ops share, written once."""
    k_new = torch.where(active[:, None], k - delta, k)
    ratio = delta / scale
    return k_new, torch.sqrt(torch.mean(ratio * ratio, dim=-1))


def fused_newton_iter(lu, perm, k, fk, active, scale):
    """One whole chord-Newton iteration against a prefactored LU, as ONE op:
    residual, permutation gather, the two triangular substitutions, the
    masked commit and the scaled-RMS convergence norm.

    lu:     (b, f, f) packed LU factors from ``batched_lu_factor``
    perm:   (b, f) int32 row permutation from ``batched_lu_factor``
    k:      (b, f) current stage iterate
    fk:     (b, f) vf evaluation at the iterate, ``eval_fn(k)``
    active: (b,) bool -- instances still iterating
    scale:  (b, f) error scale atol + rtol*|y| (may broadcast)

    Returns ``(k_new, res_norm)`` exactly like ``masked_newton_update``; the
    update solved here is ``delta = M^{-1} (k - fk)`` via the LU factors.
    """
    delta = _lu_solve_perm(lu, perm, k - fk)
    return _masked_commit(k, delta, active, scale)


def masked_newton_update(k, delta, active, scale):
    """One fused masked Newton commit: apply the update only where an
    instance's nonlinear solve is still active, and report the scaled RMS
    norm of the update (the per-instance convergence measure).

    k:      (b, f) current stage iterate
    delta:  (b, f) Newton update (solution of the linearized system)
    active: (b,) bool -- instances still iterating
    scale:  (b, f) error scale atol + rtol*|y| (may broadcast)

    Returns (k_new, res_norm): k - delta where active (k elsewhere), and the
    (b,) RMS of delta/scale.
    """
    return _masked_commit(k, delta, active, scale)


def masked_bisect_refine(coeffs, lo, hi, v_lo, v_mid, active):
    """One masked bisection refinement on the dense-output interpolant.

    The event localizer brackets a sign change of the condition function in
    interpolant coordinates x in [0, 1].  Given the bracket, the condition
    value at its low end and at its midpoint, this op halves the bracket
    (keeping the sign change inside) and evaluates the interpolant at the NEW
    midpoint -- the caller then evaluates the condition there and iterates.

    coeffs: tuple of (b, f) Horner coefficients, low -> high degree
    lo, hi: (b,) current bracket
    v_lo:   (b,) condition value at lo
    v_mid:  (b,) condition value at (lo + hi)/2
    active: (b,) bool -- instances still refining (others keep their bracket)

    Returns ``(lo', hi', v_lo', mid', y_mid')`` with ``mid' = (lo' + hi')/2``
    and ``y_mid'`` the interpolant there (evaluated for every row; inactive
    rows' brackets are frozen).
    """
    mid = 0.5 * (lo + hi)
    # The crossing is in [lo, mid] iff the condition changes sign there
    # (v_mid == 0 counts: the event is at/before the midpoint).  A NaN value
    # picks the left half, as in the JAX package, where sign(NaN) is NaN and
    # compares unequal to everything; torch.sign(NaN) is 0, hence the isnan.
    left = (torch.sign(v_lo) != torch.sign(v_mid)) | torch.isnan(v_lo) | torch.isnan(v_mid)
    hi_new = torch.where(active & left, mid, hi)
    lo_new = torch.where(active & ~left, mid, lo)
    v_lo_new = torch.where(active & ~left, v_mid, v_lo)
    mid_new = 0.5 * (lo_new + hi_new)
    xe = mid_new[:, None]
    acc = coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * xe + c
    return lo_new, hi_new, v_lo_new, mid_new, acc


def pid_update(
    err_ratio, dt, prev_inv, prev2_inv,
    *, b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max,
):
    """The Soederlind digital-filter step update behind ``PIDController``.

    err_ratio: (b,) weighted RMS error ratio of this step
    dt:        (b,) step size just attempted (signed)
    prev_inv / prev2_inv: (b,) inverse error ratios of the last two accepts
    b1/b2/b3:  Soederlind exponents (already divided by the controller order)

    Returns ``(accept, dt_next, new_inv, new_inv2)``.
    """
    dtype = dt.dtype
    # Guard: err_ratio == 0 (exact solve) -> use factor_max.
    finite = torch.isfinite(err_ratio)
    safe_ratio = torch.where(finite & (err_ratio > 0.0), err_ratio, 1.0)
    inv = 1.0 / safe_ratio

    factor = safety * inv**b1 * prev_inv**b2 * prev2_inv**b3
    factor = torch.where(err_ratio == 0.0, factor_max, factor)
    # Non-finite error estimate: treat as a hard reject, halve the step.
    factor = torch.where(finite, factor, 0.5)
    factor = torch.clamp(factor, factor_min, factor_max)

    accept = finite & (err_ratio <= 1.0)
    # On rejection never grow the step.
    factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))

    mag = torch.clamp(torch.abs(dt) * factor.to(dtype), dt_min, dt_max)
    dt_next = torch.sign(dt) * mag

    # Error history advances only on accepted steps (torchode semantics).
    new_inv = torch.where(accept, inv, prev_inv)
    new_inv2 = torch.where(accept, prev_inv, prev2_inv)
    return accept, dt_next, new_inv, new_inv2


def interp_eval(coeffs, x, mask, out):
    """Masked Horner evaluation of the dense-output polynomial.

    coeffs: tuple of (b, f) tensors, low -> high degree
    x:      (b, n) normalized evaluation positions
    mask:   (b, n) bool -- which (instance, point) cells to write this step
    out:    (b, n, f) existing output buffer

    Returns updated (b, n, f) buffer: where mask, p(x); elsewhere out.
    """
    xe = x[:, :, None]
    acc = coeffs[-1][:, None, :].expand(xe.shape[:2] + coeffs[-1].shape[-1:])
    for c in coeffs[-2::-1]:
        acc = acc * xe + c[:, None, :]
    return torch.where(mask[:, :, None], acc, out)


def interp_eval_window(coeffs, x, mask, out, cursor):
    """``interp_eval`` on a window of W eval points per row, starting at the
    per-row ``cursor``: gather the (b, W, f) window of ``out``, merge, and
    scatter it back (the windowed dense-output write of the JAX ``step.py``).

    x, mask: (b, W); out: (b, n, f); cursor: (b,) int64 with cursor <= n - W.
    Returns the updated (b, n, f) buffer.
    """
    W = x.shape[1]
    idx = (cursor[:, None] + torch.arange(W, device=cursor.device))[:, :, None]
    idx = idx.expand(-1, -1, out.shape[-1])
    merged = interp_eval(coeffs, x, mask, torch.gather(out, 1, idx))
    return out.scatter(1, idx, merged)


def poly_eval(y, coeffs):
    """Elementwise polynomial vector field: sum_d coeffs[d] * y**d (Horner).

    ``coeffs`` is a static tuple, low -> high degree; each entry is a float
    (feature-shared) or a length-f tuple.  The one evaluation program shared by
    ``PolynomialTerm.vf`` and ``fused_step_poly``: a multiply, then an add, per
    degree, each rounded on its own.  A float coefficient stays a Python
    number (cast to ``y``'s dtype by the op, as the JAX ref casts it), so no
    tensor is made per call.
    """
    cs = [float(c) if np.ndim(c) == 0
          else torch.tensor(c, dtype=y.dtype, device=y.device) for c in coeffs]
    acc = cs[-1]
    for c in cs[-2::-1]:
        acc = acc * y + c
    if not isinstance(acc, torch.Tensor) or acc.shape != y.shape:
        acc = torch.as_tensor(acc, dtype=y.dtype, device=y.device).expand(y.shape).contiguous()
    return acc


def fused_step(
    y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
    atol, rtol, *, b_sol, b_err, ctrl, want_coeffs, ctrl_mode="pid",
    failed=None, f0=None,
):
    """One fused explicit-RK step attempt around the vf calls: stage combine,
    WRMS error norm, controller decision, masked commit of (t, y, f) against
    the ``running`` mask, and the dense-output coefficient build.

    y:        (b, f) current state
    K:        (s, b, f) stacked stage derivatives; K[0] is f(t, y) (FSAL cache)
    f1:       (b, f) derivative at (t + dt, y1) (the FSAL last stage, or the
              trailing evaluation for non-FSAL tableaus)
    t:        (b,) current time;  t_new: (b,) time reached if accepted
    dt_cur:   (b,) the standing step proposal (pre-clamp, fed to the controller)
    safe_dt:  (b,) the signed step the stages actually used
    running / prev_inv / prev2_inv: (b,) loop mask + controller history
    b_sol / b_err: tableau weights
    ctrl:     ``(b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max)``
              from ``PIDController.filter_params`` (``()`` under
              ``ctrl_mode="fixed"``)
    want_coeffs: build the cubic-Hermite coefficients too (dense output)
    ctrl_mode: ``"pid"`` runs the Soederlind filter; ``"fixed"`` is the
              ``FixedController`` contract: accept everything that is running,
              keep the standing dt proposal and leave the history untouched.
    failed:   optional (b,) bool -- instances whose implicit stage solve
              failed: ``err_ratio = inf`` before the controller, and never
              accepted.
    f0:       optional (b, f) derivative cache f(t, y), kept by rejected rows
              and read by the Hermite build; None means K[0].  A diagonally
              implicit tableau whose first stage is implicit (implicit_euler)
              has K[0] != f(t, y) and passes it.

    Returns ``(y1, err_ratio, accept, y_out, f_out, t_out, dt_out, new_inv,
    new_inv2, coeffs)`` with ``coeffs = (c0, c1, c2, c3)`` or ``None``.
    """
    y1, err = fused_update(y, K, safe_dt, b_sol, b_err)
    err_ratio = error_norm(err, y, y1, atol, rtol)
    if failed is not None:
        err_ratio = torch.where(failed, torch.inf, err_ratio)
    if ctrl_mode == "fixed":
        accept = torch.ones(dt_cur.shape, dtype=torch.bool, device=dt_cur.device)
        dt_next = dt_cur
        new_inv, new_inv2 = prev_inv, prev2_inv
    else:
        b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max = ctrl
        accept, dt_next, new_inv, new_inv2 = pid_update(
            err_ratio, dt_cur, prev_inv, prev2_inv,
            b1=b1, b2=b2, b3=b3, safety=safety,
            factor_min=factor_min, factor_max=factor_max,
            dt_min=dt_min, dt_max=dt_max,
        )
    accept = accept & running
    if failed is not None:
        accept = accept & ~failed
    acc_f = accept[:, None]
    k0 = K[0] if f0 is None else f0
    y_out = torch.where(acc_f, y1, y)
    f_out = torch.where(acc_f, f1, k0)
    t_out = torch.where(accept, t_new, t)
    dt_out = torch.where(running, dt_next, dt_cur)
    coeffs = hermite_coeffs(y, y1, k0, f1, safe_dt) if want_coeffs else None
    return y1, err_ratio, accept, y_out, f_out, t_out, dt_out, new_inv, new_inv2, coeffs


def poly_stages(y, f0, dt, a, poly):
    """The stage recursion of an explicit tableau for a polynomial vector
    field: K (s, b, f) with K[0] = f0, built as ``rk_step`` builds it (one
    (s, b, f) buffer, ``stage_accum`` over its prefix).  ``a``: (s, s)."""
    s = len(a)
    K = torch.empty((s,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    K[0] = f0
    for i in range(1, s):
        K[i] = poly_eval(stage_accum(y, dt, K[:i], np.asarray(a[i])[:i]), poly)
    return K


def fused_step_poly(
    y, f0, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
    atol, rtol, *, a, c, b_sol, b_err, poly, ctrl, want_coeffs,
    fsal=True, ctrl_mode="pid",
):
    """The whole step attempt for a polynomial vector field: the stage
    evaluations fuse too (zero vf launches).  ``a``/``c`` are the tableau
    arrays, ``poly`` the coefficient tuple of ``poly_eval``.  For FSAL
    tableaus f1 is the last stage; otherwise the trailing evaluation
    f(t + dt, y1) happens here on every attempt, as in the unfused
    ``rk_step``.  Everything else as in ``fused_step``.
    """
    del c  # autonomous polynomial dynamics: stage times never enter
    K = poly_stages(y, f0, safe_dt, a, poly)
    if fsal:
        f1 = K[-1]
    else:
        y1, _ = fused_update(y, K, safe_dt, b_sol, b_err)
        f1 = poly_eval(y1, poly)
    return fused_step(
        y, K, f1, t, t_new, dt_cur, safe_dt, running, prev_inv, prev2_inv,
        atol, rtol, b_sol=b_sol, b_err=b_err, ctrl=ctrl,
        want_coeffs=want_coeffs, ctrl_mode=ctrl_mode,
    )


def fused_event_detect(v_prev, v_new, fired, accept, *, directions):
    """Fused per-event sign test of the event layer: scipy's zero-crossing
    detection for EVERY registered event in one op, plus the masked carry of
    the condition values (only accepted steps advance them).

    v_prev: (b, E) condition values at the current accepted state
    v_new:  (b, E) condition values at the candidate state
    fired:  (b, E) bool -- crossings already recorded (these never re-fire)
    accept: (b,) bool -- this step's accept mask (already masked by running)
    directions: static tuple of per-event crossing directions (0 / +1 / -1)

    Returns ``(newly, v_keep)``: the (b, E) bool "newly crossed this step"
    mask and the carried (b, E) condition values.
    """
    crossed = []
    for i, d in enumerate(directions):
        v0, v1 = v_prev[:, i], v_new[:, i]
        up = (v0 <= 0.0) & (v1 >= 0.0)
        down = (v0 >= 0.0) & (v1 <= 0.0)
        if d > 0:
            c = up
        elif d < 0:
            c = down
        else:
            c = up | down
        crossed.append(c & ((v0 != 0.0) | (v1 != 0.0)))
    newly = torch.stack(crossed, dim=1) & ~fired & accept[:, None]
    v_keep = torch.where(accept[:, None], v_new, v_prev)
    return newly, v_keep


def fused_event_commit(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y, *, terminal):
    """Fused event-record commit: terminal resolution (the earliest terminal
    crossing wins), the first-crossing bookkeeping update and the stop
    outputs of one step's event processing, as one op.

    x:      (b, E) localized crossing positions in interpolant coordinates
    y_ev:   (b, E, f) interpolated states at the crossings
    newly:  (b, E) bool -- crossings detected this step
    y_new:  (b, f) the accepted candidate state (stop fallback)
    t0, dt: (b,) step start times / signed step sizes
    fired / ev_t / ev_y: the recorded-crossing bookkeeping being advanced
    terminal: static tuple of per-event terminal flags

    Returns ``(fired', ev_t', ev_y', stop, t_stop, y_stop, n_new)``: bool
    ``fired'`` and ``stop``, int32 ``n_new``.
    """
    b = x.shape[0]
    x_stop = torch.full((b,), torch.inf, dtype=t0.dtype, device=t0.device)
    y_stop = y_new
    stop = torch.zeros((b,), dtype=torch.bool, device=t0.device)
    for i, term in enumerate(terminal):
        if not term:
            continue
        stop = stop | newly[:, i]
        earlier = newly[:, i] & (x[:, i] < x_stop)
        y_stop = torch.where(earlier[:, None], y_ev[:, i], y_stop)
        x_stop = torch.where(earlier, x[:, i], x_stop)
    rec = newly & (x <= x_stop[:, None])

    t_ev = t0[:, None] + x * dt[:, None]
    return (
        fired | rec,
        torch.where(rec, t_ev, ev_t),
        torch.where(rec[:, :, None], y_ev, ev_y),
        stop,
        t0 + torch.where(stop, x_stop, 0.0) * dt,
        y_stop,
        rec.sum(dim=1).to(torch.int32),
    )


# ------------------------------------------------------------ flash attention
# The plain versions of the JAX package's flash-attention forward
# (``kernels/flash_attn.py``): the pair schedule and online-softmax body of
# the Pallas kernel, with the padding and ``q_offset`` of
# ``models/attention.flash_attention``, and the quadratic oracle.

NEG_INF = -1e30  # the masked score of the reference (not -inf)


def flash_pairs(nq, nk, qc, kc, sk0, causal, q_offset):
    """The (qi, ki) blocks whose scores are not all masked, in the order the
    reference visits them (``models/attention._block_pairs``): keys at or
    past ``sk0`` are padding, and with ``causal`` a block wholly above the
    diagonal is skipped.  With ``q_offset = 0`` and ``sk0 = nk * kc`` this is
    ``flash_attn._pairs``."""
    pairs = []
    for qi in range(nq):
        q_hi = q_offset + (qi + 1) * qc - 1  # highest query position in the block
        for ki in range(nk):
            k_lo = ki * kc
            if k_lo >= sk0:
                continue
            if causal and k_lo > q_hi:
                continue
            pairs.append((qi, ki))
    return pairs


def _attn_dtype(dtype):
    """The attention's working dtype: float32, as the reference computes for
    every input; float64 inputs compute in float64 (the oracle of the card's
    checks; the kernels take float32 and bfloat16 only)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _attn_blocks(q, k, v, q_chunk, kv_chunk):
    """Shared set-up of the blocked forward and backward: the chunks (qc,
    kc), the padded lengths' block counts (nq, nk) and q, k, v padded up to
    chunk multiples along their sequence axis."""
    sq0, sk0 = q.shape[1], k.shape[1]
    qc, kc = min(q_chunk, sq0), min(kv_chunk, sk0)
    pq, pk = (-sq0) % qc, (-sk0) % kc
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    return qc, kc, (sq0 + pq) // qc, (sk0 + pk) // kc, q, k, v


def _block_mask(qi, ki, qc, kc, sk0, causal, q_offset, device):
    """The (qc, kc) mask of one block pair: padded keys, and with
    ``causal`` the keys after each query's position."""
    q_pos = q_offset + qi * qc + torch.arange(qc, device=device)
    k_pos = ki * kc + torch.arange(kc, device=device)
    mask = (k_pos >= sk0)[None, :]
    if causal:
        mask = mask | (k_pos[None, :] > q_pos[:, None])
    return mask


def flash_attention_fwd(q, k, v, *, causal=True, q_offset=0, q_chunk=256, kv_chunk=128,
                        lse=False):
    """GQA flash attention, forward: q (b, sq, H, hd); k, v (b, sk, KV, hd)
    with H % KV == 0.  Query head h reads KV head h // (H // KV); ``q_offset``
    is the absolute position of q[:, 0] against k[:, 0].

    Ragged lengths are padded up to chunk multiples and the padded keys
    masked; each q-block runs the online softmax over its pairs with float32
    (m, l) and accumulator, masked scores at -1e30, and is normalized by
    max(l, 1e-30).  Returns (b, sq, H, hd) in q's dtype; with ``lse`` also
    each row's log-sum-exp m + log l, (b, H, sq) in the working dtype, for
    ``flash_attention_bwd``.  float64 inputs compute in float64."""
    b, sq0, H, hd = q.shape
    sk0, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attention_fwd: {H} query heads over {KV} KV heads")
    G = H // KV
    cdt = _attn_dtype(q.dtype)
    qc, kc, nq, nk, q, k, v = _attn_blocks(q, k, v, q_chunk, kv_chunk)
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=cdt, device=q.device)
    qr = q.reshape(b, nq, qc, KV, G, hd)
    kr = k.reshape(b, nk, kc, KV, hd)
    vr = v.reshape(b, nk, kc, KV, hd)
    # zeros, as the reference's scan starts: a q-block with no pair stays 0
    out = torch.zeros((b, nq * qc, H, hd), dtype=q.dtype, device=q.device)
    row_lse = torch.zeros((b, KV, G, nq * qc), dtype=cdt, device=q.device)
    pairs = flash_pairs(nq, nk, qc, kc, sk0, causal, q_offset)
    for qi in sorted({p[0] for p in pairs}):
        m = torch.full((b, KV, G, qc), NEG_INF, dtype=cdt, device=q.device)
        l = torch.zeros((b, KV, G, qc), dtype=cdt, device=q.device)
        acc = torch.zeros((b, KV, G, qc, hd), dtype=cdt, device=q.device)
        qb = qr[:, qi].to(cdt) * scale
        for _, ki in (p for p in pairs if p[0] == qi):
            s = torch.einsum("bqKGh,bkKh->bKGqk", qb, kr[:, ki].to(cdt))
            s = torch.where(_block_mask(qi, ki, qc, kc, sk0, causal, q_offset, q.device),
                            NEG_INF, s)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bKGqk,bkKh->bKGqh", p,
                                                       vr[:, ki].to(cdt))
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, qi * qc:(qi + 1) * qc] = o.permute(0, 3, 1, 2, 4).reshape(b, qc, H, hd)
        row_lse[..., qi * qc:(qi + 1) * qc] = m + torch.log(l)
    if lse:
        return out[:, :sq0], row_lse.reshape(b, H, -1)[..., :sq0]
    return out[:, :sq0]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, q_offset=0, q_chunk=256,
                        kv_chunk=128):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd``'s output ``o``
    under the cotangent ``do``, from the forward's inputs, ``o`` and its
    log-sum-exp ``lse`` (b, H, sq).  Block by block over the same pairs as
    the forward (``flash_pairs``), never an (sq, sk) matrix: with s the
    scaled, masked scores of a pair, p = exp(s - lse), dp = do v^T and ds =
    p (dp - D), D = rowsum(do * o),

        dv += p^T do,  dk += ds^T (scale q),  dq += scale ds k,

    dk and dv summed over each KV head's H // KV query heads.  float32
    arithmetic (float64 for float64 inputs), each gradient in its input's
    dtype: what autograd of ``flash_attention_fwd`` gives, to rounding."""
    b, sq0, H, hd = q.shape
    sk0, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attention_bwd: {H} query heads over {KV} KV heads")
    G = H // KV
    cdt = _attn_dtype(q.dtype)
    qc, kc, nq, nk, q_p, k_p, v_p = _attn_blocks(q, k, v, q_chunk, kv_chunk)
    pad = nq * qc - sq0
    # padded rows: zero cotangent, so they add nothing to dk and dv
    do_p = torch.nn.functional.pad(do.to(cdt), (0, 0, 0, 0, 0, pad))
    delta = (do.to(cdt) * o.to(cdt)).sum(-1)  # (b, sq, H)
    delta = torch.nn.functional.pad(delta, (0, 0, 0, pad)).reshape(b, nq, qc, KV, G)
    lse_p = torch.nn.functional.pad(lse.to(cdt), (0, pad)).reshape(b, KV, G, nq, qc)
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=cdt, device=q.device)
    qr = q_p.reshape(b, nq, qc, KV, G, hd)
    kr = k_p.reshape(b, nk, kc, KV, hd)
    vr = v_p.reshape(b, nk, kc, KV, hd)
    dor = do_p.reshape(b, nq, qc, KV, G, hd)
    dq = torch.zeros((b, nq, qc, KV, G, hd), dtype=cdt, device=q.device)
    dk = torch.zeros((b, nk, kc, KV, hd), dtype=cdt, device=q.device)
    dv = torch.zeros((b, nk, kc, KV, hd), dtype=cdt, device=q.device)
    for qi, ki in flash_pairs(nq, nk, qc, kc, sk0, causal, q_offset):
        qb = qr[:, qi].to(cdt) * scale
        kb, vb, dob = kr[:, ki].to(cdt), vr[:, ki].to(cdt), dor[:, qi]
        s = torch.einsum("bqKGh,bkKh->bKGqk", qb, kb)
        s = torch.where(_block_mask(qi, ki, qc, kc, sk0, causal, q_offset, q.device), NEG_INF, s)
        p = torch.exp(s - lse_p[:, :, :, qi, :, None])
        dp = torch.einsum("bqKGh,bkKh->bKGqk", dob, vb)
        ds = p * (dp - delta[:, qi].permute(0, 2, 3, 1)[..., None])
        dv[:, ki] += torch.einsum("bKGqk,bqKGh->bkKh", p, dob)
        dk[:, ki] += torch.einsum("bKGqk,bqKGh->bkKh", ds, qb)
        dq[:, qi] += torch.einsum("bKGqk,bkKh->bqKGh", ds, kb) * scale
    dq = dq.reshape(b, nq * qc, H, hd)[:, :sq0]
    dk = dk.reshape(b, nk * kc, KV, hd)[:, :sk0]
    dv = dv.reshape(b, nk * kc, KV, hd)[:, :sk0]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_ref(q, k, v, *, causal=True):
    """The quadratic oracle of ``flash_attn.ref``: the whole (sq, sk) score
    matrix, masked at -1e30 above the diagonal, softmax in float32.  Returns
    (b, sq, H, hd) in q's dtype."""
    b, sq, H, hd = q.shape
    sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(b, sq, KV, G, hd) / np.sqrt(hd)
    s = torch.einsum("bqKGh,bkKh->bKGqk", qf, k.float())
    if causal:
        pos = torch.arange(max(sq, sk), device=q.device)
        above = pos[None, :sk] > pos[:sq, None]
        s = torch.where(above, NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bKGqk,bkKh->bKGqh", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, H, hd).to(q.dtype)
