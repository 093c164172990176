"""Offline optimizer for the composite polynomial sign-filter schedules.

Produces the coefficient tables hard-coded in cuadmm_jax/ops/polyfilter.py.
Method (cf. arXiv:2507.09165 / arXiv:2505.16932; this implementation is
independent): greedily compose odd degree-5 polynomials
p(y) = a y + b y^3 + c y^5.

- While the tracked lower bound l < 0.5, each step solves the LP
    maximize m  s.t.  p(y) >= m on [l, u'],  0 <= p(y) <= U on [0, u']
  (inflation: push the smallest resolvable eigenvalue toward 1 while the
  whole [0, u'] image stays bounded -- values below l can never escape).
- Afterwards, polish steps solve the minimax LP
    minimize t  s.t.  |p(y) - 1| <= t on [l, u'],  0 <= p(y) <= U on [0, u'].

Both are linear in (a, b, c), so scipy's HiGHS solves them exactly; the
attained interval is re-measured on a fine grid rather than trusted from
the LP (this matters -- composite filters amplify any unmodeled overshoot
catastrophically).

ROBUSTNESS MARGIN (a round-2 divergence): u' = u*(1+mu) with
mu=1e-3, and U must be < u'/(1+mu) -- i.e. the composition must be a
strict contraction of the invariant interval even when matmul round-off
perturbs eigenvalues by up to mu relative. The original tables used
U = 1.2 with the image bound attained *exactly* at the interval edge:
p(1.2) = 1.2 was a repelling fixed point with slope ~13, so a +1.8e-6
eigenvalue overshoot (an f32 accumulation that rounds the boundary point
*up*; CPU FMA f32 rounds the same point *down*) amplified ~13x per step and blew the
whole solve up within one projection: 13^8 * 1.8e-6 ~ 1e2 at step 8,
3.5e9 at step 9 -- the round-2 failure signature.

Usage: python benchmarks/sign_schedule_opt.py [l0] [tol] [U] [mu]
"""

import sys

import numpy as np
from scipy.optimize import linprog


def _grid(l, u, n=3000):
    lo = max(l * 1e-3, 1e-12)
    g = np.concatenate([np.logspace(np.log10(lo), np.log10(u), n), np.linspace(lo, u, n)])
    return np.unique(g)


def _vand(y):
    return np.stack([y, y**3, y**5], axis=1)


def inflate_step(l, u, U, mu):
    up = u * (1.0 + mu)  # robustness: tolerate mu-relative eigenvalue overshoot
    y_all = _grid(l, up)
    y_core = y_all[y_all >= l]
    Va, Vc = _vand(y_all), _vand(y_core)
    A_ub = np.vstack(
        [
            np.hstack([-Vc, np.ones((len(Vc), 1))]),  # m - p <= 0 on [l,u']
            np.hstack([Va, np.zeros((len(Va), 1))]),  # p <= U on [0,u']
            np.hstack([-Va, np.zeros((len(Va), 1))]),  # p >= 0 on [0,u']
        ]
    )
    b_ub = np.concatenate([np.zeros(len(Vc)), np.full(len(Va), U), np.zeros(len(Va))])
    res = linprog(
        np.array([0, 0, 0, -1.0]),
        A_ub=A_ub,
        b_ub=b_ub,
        bounds=[(None, None)] * 4,
        method="highs",
    )
    assert res.success, (l, u)
    a, b, c, _ = res.x
    # Track the attained interval on the *nominal* [l, u]: the mu margin
    # models one step of round-off, certified by the LP constraints on
    # [0, u']; folding it into the tracked bounds would re-inflate them
    # every step and block convergence.
    yf = _grid(l, u, 20000)
    p = a * yf[yf >= l] + b * yf[yf >= l] ** 3 + c * yf[yf >= l] ** 5
    return (a, b, c), p.min(), p.max()


def polish_step(l, u, U, mu):
    up = u * (1.0 + mu)
    # Minimax accuracy on the nominal [l, u]; round-off excursions up to u'
    # only need the containment constraint below, not accuracy.
    y = np.linspace(l, u, 4000)
    V = _vand(y)
    y_img = _grid(l, up)  # image bound applies on all of [0, u']
    Vi = _vand(y_img)
    A_ub = np.vstack(
        [
            np.block([[V, -np.ones((len(y), 1))], [-V, -np.ones((len(y), 1))]]),
            np.hstack([Vi, np.zeros((len(Vi), 1))]),  # p <= U on [0,u']
            np.hstack([-Vi, np.zeros((len(Vi), 1))]),  # p >= 0 on [0,u']
        ]
    )
    b_ub = np.concatenate(
        [np.ones(len(y)), -np.ones(len(y)), np.full(len(Vi), U), np.zeros(len(Vi))]
    )
    res = linprog(
        np.array([0, 0, 0, 1.0]),
        A_ub=A_ub,
        b_ub=b_ub,
        bounds=[(None, None)] * 3 + [(0, None)],
        method="highs",
    )
    assert res.success
    a, b, c, _ = res.x
    yf = np.linspace(l, u, 20000)
    p = a * yf + b * yf**3 + c * yf**5
    return (a, b, c), p.min(), p.max()


def schedule(l0, tol=1e-13, U=1.19, mu=1e-3, max_steps=40):
    assert U * (1.0 + mu) < 1.2, "invariant interval must strictly contract"
    l, u = l0, 1.0
    out = []
    for _ in range(max_steps):
        co, l2, u2 = (
            inflate_step(l, u, U, mu) if l < 0.5 else polish_step(l, u, U, mu)
        )
        width_old, width_new = max(u - 1, 1 - l), max(u2 - 1, 1 - l2)
        if l >= 0.5 and width_new > 0.9 * width_old:
            # LP degenerates once [l,u] ~ [1,1] (all grid rows identical);
            # finish with analytic Newton-Schulz quintic steps
            # p(y) = (15y - 10y^3 + 3y^5)/8: monotone on [0, inf),
            # p([0, 1.2]) <= 1.03 (safely inside the invariant interval),
            # and p(1+e) = 1 + 2.5e^3 -- cubic contraction.
            w = width_old
            while w > tol and len(out) < max_steps:
                out.append((15.0 / 8.0, -10.0 / 8.0, 3.0 / 8.0))
                w = 2.5 * w**3
            break
        out.append(co)
        l, u = l2, u2
        if max(u - 1, 1 - l) < tol:
            break
    return out


def validate(sched, l0, dtype):
    y = np.unique(
        np.concatenate([np.logspace(-12, 0, 6000), np.linspace(0, 1, 6000)])
    ).astype(dtype)
    s = y.copy()
    for a, b, c in sched:
        s = (dtype(a) * s + dtype(b) * s**3 + dtype(c) * s**5).astype(dtype)
    m = y >= l0
    return np.abs(s[m] - 1).max(), np.abs(y * (s - 1) / 2).max()


def validate_adversarial(sched, eps):
    """Inject a +eps perturbation at the interval maximum after every step
    (models matmul round-off pushing the top eigenvalue past the tracked
    bound) and report the worst value ever attained. Must stay bounded by
    ~1.2 for the schedule to be platform-robust."""
    y = np.unique(
        np.concatenate([np.logspace(-12, 0, 4000), np.linspace(0, 1.0, 4000)])
    )
    y = y * (1.0 + eps)
    worst = y.max()
    for a, b, c in sched:
        y = a * y + b * y**3 + c * y**5
        y = y + eps  # adversarial per-step overshoot
        worst = max(worst, np.abs(y).max())
    return worst, np.abs(y - 1).max() if len(y) else 0.0


if __name__ == "__main__":
    l0 = float(sys.argv[1]) if len(sys.argv) > 1 else 1e-6
    tol = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-13
    U = float(sys.argv[3]) if len(sys.argv) > 3 else 1.19
    mu = float(sys.argv[4]) if len(sys.argv) > 4 else 1e-3
    sched = schedule(l0, tol, U, mu)
    sign_err, proj_err = validate(sched, l0, np.float64)
    worst, _ = validate_adversarial(sched, 1e-5)
    print(f"# l0={l0:g} tol={tol:g} U={U} mu={mu:g}: {len(sched)} steps, "
          f"sign err {sign_err:.2e}, proj err {proj_err:.2e}, "
          f"adversarial(1e-5) worst {worst:.6f}")
    for co in sched:
        print("    (%.17f, %.17f, %.17f)," % co)
