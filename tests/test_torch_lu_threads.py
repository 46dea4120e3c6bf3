"""The port's plain LU on two CPU threads, at the widths where a batched
LAPACK call once never returned (ROADMAP C-9).

- (a) ``ref.batched_lu_factor`` and ``ref.batched_linsolve`` at f in {160,
  200, 256}, float32 and float64, under ``torch.set_num_threads(2)``, in a
  subprocess with a time limit, so that a regression fails and does not hang
  the run: ``A[perm] == L @ U`` to 1e-5 / 1e-12 of the largest entry of A,
  the solve's residual to the same of ``|A| |x| + |rhs|``, and the linsolve
  bitwise the LU then the substitution.
- (b) a float64 ``kvaerno5`` solve of the Allen-Cahn method of lines at f =
  160 on two threads (in the same subprocess) against the JAX package's
  ``solve_ivp``: equal step, Newton and Jacobian counts and status, ``ys``
  within 1e-9.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402

WIDTHS = (160, 200, 256)
DTYPES = ("float32", "float64")
TIMEOUT = 60
STATS = ("n_steps", "n_accepted", "n_f_evals", "n_newton_iters", "n_jac_evals")

# The Allen-Cahn method of lines (Dirichlet, lam * Lap(y) + y - y**3, lam =
# (f + 1)**2) at f = 160, b = 2: y0 = amplitude * sin(pi x).
AC_F = 160
AC_B = 2
AC_KW = dict(t_start=0.0, t_end=1.0, rtol=1e-4, atol=1e-7, method="kvaerno5")


def _allen_cahn_y0():
    x = np.linspace(0.0, 1.0, AC_F + 2)[1:-1]
    return np.linspace(1.0, 1.6, AC_B)[:, None] * np.sin(np.pi * x)[None, :]


# Run in a fresh interpreter on two threads: factors every (f, dtype) case,
# solves the Allen-Cahn problem with the port on the CPU, and prints one
# JSON object of relative errors, the solve's counts and its final state.
_PROBE = """
import json, sys
import numpy as np
import torch
import repro_torch.core as T
from repro_torch.kernels import ref
from repro_torch.tools import newton_checks as NC
torch.set_num_threads(2)
out = {}
for f in %(widths)r:
    for name in %(dtypes)r:
        dtype = getattr(torch, name)
        M, rhs, *_ = NC.newton_inputs(f, 4, f, getattr(__import__("numpy"), name))
        A, g = torch.as_tensor(M), torch.as_tensor(rhs)
        lu, perm = ref.batched_lu_factor(A)
        b = A.shape[0]
        L = torch.tril(lu, -1) + torch.eye(f, dtype=dtype)
        PA = torch.gather(A, 1, perm.long()[:, :, None].expand(b, f, f))
        x = ref.batched_linsolve(A, g)
        res = (A @ x[..., None])[..., 0] - g
        scale = (A.abs() @ x.abs()[..., None])[..., 0] + g.abs()
        out[f"{f}-{name}"] = dict(
            lu=float((PA - L @ torch.triu(lu)).abs().max() / A.abs().max()),
            solve=float((res.abs() / scale).max()),
            bitwise=bool(torch.equal(x, ref._lu_solve_perm(lu, perm, g))),
            is_perm=bool(torch.equal(perm.sort(dim=1).values,
                                     torch.arange(f, dtype=perm.dtype).expand(b, f))))

def allen_cahn(t, y, lam):
    up = torch.cat([y[..., 1:], torch.zeros_like(y[..., :1])], dim=-1)
    dn = torch.cat([torch.zeros_like(y[..., :1]), y[..., :-1]], dim=-1)
    return lam * (up - 2.0 * y + dn) + y - y**3

x = np.linspace(0.0, 1.0, %(f)d + 2)[1:-1]
y0 = np.linspace(1.0, 1.6, %(b)d)[:, None] * np.sin(np.pi * x)[None, :]
sol = T.solve_ivp(allen_cahn, y0, None, args=float((%(f)d + 1) ** 2), device="cpu", **%(kw)r)
out["solve"] = dict(ys=sol.ys.tolist(), status=sol.status.tolist(),
                    **{k: sol.stats[k].tolist() for k in %(stats)r})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def factored():
    """The probe's results, or the reason it gave none."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.abspath(src), os.environ.get("PYTHONPATH")) if p))
    try:
        probe = _PROBE % dict(widths=WIDTHS, dtypes=DTYPES, f=AC_F, b=AC_B, kw=AC_KW,
                              stats=STATS)
        run = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                             timeout=TIMEOUT, env=env)
    except subprocess.TimeoutExpired:
        return f"did not return within {TIMEOUT} s on two threads"
    if run.returncode != 0:
        return f"exited {run.returncode}: {run.stderr[-2000:]}"
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", WIDTHS)
def test_lu_and_linsolve_return_on_two_threads(factored, f, dtype):
    assert isinstance(factored, dict), factored
    got = factored[f"{f}-{dtype}"]
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert got["is_perm"]
    assert got["lu"] <= tol, got
    assert got["solve"] <= tol, got
    assert got["bitwise"]


# ------------------------------------------------- (b) a solve at f = 160


def _allen_cahn_j(t, y, lam):
    up = jnp.concatenate([y[..., 1:], jnp.zeros_like(y[..., :1])], axis=-1)
    dn = jnp.concatenate([jnp.zeros_like(y[..., :1]), y[..., :-1]], axis=-1)
    return lam * (up - 2.0 * y + dn) + y - y**3


def test_kvaerno5_solve_at_f160_on_two_threads_matches_jax(factored):
    assert isinstance(factored, dict), factored
    got = factored["solve"]
    with jax.enable_x64(True):
        sol = J.solve_ivp(_allen_cahn_j, jnp.asarray(_allen_cahn_y0()), None,
                          args=float((AC_F + 1) ** 2), **AC_KW)
        want = dict(ys=np.asarray(sol.ys), status=np.asarray(sol.status),
                    **{k: np.asarray(sol.stats[k]) for k in STATS})
    assert (want["status"] == 0).all()
    np.testing.assert_array_equal(got["status"], want["status"])
    for k in STATS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(np.asarray(got["ys"]), want["ys"], rtol=1e-9, atol=1e-9)
