"""The port's examples (``repro_torch.examples``) against the JAX package's
``examples/*.py``, on the CPU, from the same numpy values.

- quickstart: the one-liner, the component API, the PID controller and the
  dict state, float64, the reference's calls of ``examples/quickstart.py``
  repeated here on ``repro.core`` (the script runs at module level): ``ys``
  within 1e-9, ``status`` and ``n_steps`` equal.
- bouncing_ball: four bounces in float64 against the same loop on
  ``repro.core``: impact times and states within 1e-9.
- cnf_density: the reference's MLP and points (``benchmarks/cnf_bench.py``'s
  ``init_mlp`` / ``two_moons``, carried by ``convert.
  example_params_from_numpy``) in float64 at 128 points, three iterations
  through ``make_adjoint_solve(mode="joint")``: every NLL and the first
  gradient within 1e-8 relative.
- latent_ode: ``main``'s first three losses within 1e-8 relative; the
  service loop at two iterations, its first served gradients within 1e-9 of
  the reference's ``SolveService`` on the same requests (ROADMAP C-2: not
  bitwise across frameworks) and, inside the example, bitwise equal to the
  port's solo ``ScanAdjoint`` solve.
- train_lm and continuous_depth_lm: the launcher arguments equal the
  reference's, and three steps from the reference's initial state (the
  launcher's ``init_train_state`` patched) against the reference's jitted
  ``make_train_step`` on the same batches (its launcher fails on this JAX,
  ROADMAP C-3): losses within 1e-5 relative (1e-4 for continuous depth, the
  float32 ODE solve's controller, as ``tests/test_torch_node.py`` holds it).
  The launcher also trains the vision and encoder-decoder configs, with
  their frontend embeddings.

Each example also runs once through its ``main`` at a reduced iteration
count with ``device="cpu"``, and its asserts that hold at that count run.
"""

import dataclasses
import importlib.util
import pathlib
import runpy
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.adjoint import make_adjoint_solve as jmake_adjoint_solve  # noqa: E402
from repro.data import SyntheticTokens  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    bouncing_ball,
    cnf_density,
    continuous_depth_lm,
    example_device,
    latent_ode,
    quickstart,
    train_lm,
)
from repro_torch.launch import train as tlaunch  # noqa: E402

pytestmark = pytest.mark.reverse_diff

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reference_module(name):
    """``examples/<name>.py`` of the JAX package as a module (its top level
    defines functions only)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


# ------------------------------------------------------------------ quickstart

def _jvdp(t, y, mu):
    x, xdot = y[..., 0], y[..., 1]
    return jnp.stack((xdot, mu * (1 - x**2) * xdot - x), axis=-1)


def _jvdp_tree(t, y, mu):
    x, xdot = y["x"], y["v"]["xdot"]
    return {"x": xdot, "v": {"xdot": mu * (1 - x**2) * xdot - x}}


def test_quickstart_matches_reference():
    y0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (5, 2)), np.float64)
    mu = 10.0
    with jax.enable_x64(True):
        jy0, te = jnp.asarray(y0), jnp.linspace(0.0, 10.0, 50)
        solver = J.AutoDiffAdjoint(J.Stepper("tsit5"), J.integral_controller())
        want = {
            "sol": jax.jit(lambda y: J.solve_ivp(_jvdp, y, te, method="tsit5", args=mu))(jy0),
            "sol2": jax.jit(lambda y: solver.solve(_jvdp, y, te, args=mu))(jy0),
            "sol_pid": jax.jit(lambda y: J.AutoDiffAdjoint(
                J.Stepper("tsit5"), J.pid_controller()).solve(_jvdp, y, te, args=mu))(jy0),
            "sol3": jax.jit(lambda y: solver.solve(_jvdp_tree, y, te, args=mu))(
                {"x": jy0[:, :1], "v": {"xdot": jy0[:, 1:]}}),
        }
        want = {k: (jax.tree_util.tree_map(np.asarray, s.ys), np.asarray(s.status),
                    np.asarray(s.stats["n_steps"])) for k, s in want.items()}
    got = quickstart.main("cpu", data=torch.tensor(y0))
    for name, (ys, status, n_steps) in want.items():
        sol = got[name]
        np.testing.assert_array_equal(sol.status.numpy(), status, err_msg=name)
        np.testing.assert_array_equal(sol.stats["n_steps"].numpy(), n_steps, err_msg=name)
        if name == "sol3":
            _close(sol.ys["x"].numpy(), ys["x"], 1e-9)
            _close(sol.ys["v"]["xdot"].numpy(), ys["v"]["xdot"], 1e-9)
        else:
            assert sol.ys.dtype == torch.float64
            _close(sol.ys.numpy(), ys, 1e-9)


def test_quickstart_runs_in_float32():
    out = quickstart.main("cpu")
    assert out["sol"].ys.dtype == torch.float32 and out["sol"].ys.shape == (5, 50, 2)


# --------------------------------------------------------------- bouncing ball

def test_bouncing_ball_matches_reference():
    h0, r = bouncing_ball.h0, bouncing_ball.restitution
    ground = J.Event(lambda t, y, args: y[0], terminal=True, direction=-1.0)

    def jball(t, y, args):
        return jnp.stack((y[..., 1], jnp.full_like(y[..., 1], -bouncing_ball.G)), axis=-1)

    with jax.enable_x64(True):
        segment = jax.jit(lambda y, t: J.solve_ivp(
            jball, y, None, t_start=t, t_end=t + 10.0, events=ground, rtol=1e-6, atol=1e-9))
        y = jnp.asarray(np.stack([h0, np.zeros_like(h0)], 1))
        t = jnp.zeros((len(h0),))
        impacts, states = [], []
        for _ in range(bouncing_ball.N_BOUNCES):
            sol = segment(y, t)
            assert np.all(np.asarray(sol.status) == J.Status.EVENT.value)
            t = sol.ts
            impacts.append(np.asarray(t))
            states.append(np.asarray(sol.ys))
            y = jnp.stack([jnp.zeros_like(sol.ys[:, 0]), -jnp.asarray(r) * sol.ys[:, 1]], axis=1)
    got = bouncing_ball.main("cpu", data=torch.tensor(np.stack([h0, np.zeros_like(h0)], 1)))
    _close(got["impacts"], np.stack(impacts, 1), 1e-9)
    _close(got["states"], np.stack(states, 1), 1e-9)


def test_bouncing_ball_runs_in_float32():
    assert bouncing_ball.main("cpu")["max_err"] < 1e-3


# ------------------------------------------------------------------------- cnf

CNF_POINTS = 128


def test_cnf_density_matches_reference():
    from benchmarks.cnf_bench import aug_dynamics, clip_tree, init_mlp, nll_loss, two_moons

    key = jax.random.PRNGKey(0)
    params_np = _np64(init_mlp(key))
    x_np = np.asarray(two_moons(key, CNF_POINTS), np.float64)
    with jax.enable_x64(True):
        solve = jmake_adjoint_solve(aug_dynamics, mode="joint", rtol=1e-4, atol=1e-4)
        x = jnp.asarray(x_np)
        loss_grad = jax.jit(jax.value_and_grad(lambda p: nll_loss(p, x, solve)))
        params = jax.tree_util.tree_map(jnp.asarray, params_np)
        lr, m = 1e-2, jax.tree.map(jnp.zeros_like, params)
        nlls, first = [], None
        for _ in range(3):
            nll, g = loss_grad(params)
            first = first or _np64(g)
            g = clip_tree(g)
            m = jax.tree.map(lambda mm, gg: 0.9 * mm + gg, m, g)
            params = jax.tree.map(lambda p, mm: p - lr * mm, params, m)
            nlls.append(float(nll))
    got = cnf_density.main("cpu", iters=3,
                           params=convert.example_params_from_numpy("cnf", params_np, "cpu"),
                           data=torch.tensor(x_np))
    np.testing.assert_allclose(got["nll"], nlls, rtol=1e-8)
    for k, g in got["first_grads"].items():
        assert g.dtype == torch.float64
        _close(g.numpy(), first[k], 1e-8)


def test_cnf_density_runs_in_float32():
    out = cnf_density.main("cpu", iters=2)
    assert len(out["nll"]) == 2 and all(np.isfinite(out["nll"]))
    assert all(v.dtype == torch.float32 for v in out["params"].values())


def test_example_params_refuse_other_keys():
    with pytest.raises(ValueError, match="keys"):
        convert.example_params_from_numpy("latent_ode", {"w1": np.zeros(2)}, "cpu")


# ------------------------------------------------------------------ latent ODE

@pytest.fixture(scope="module")
def latent_ref():
    return _reference_module("latent_ode")


def _latent_inputs(ref, seed):
    key = jax.random.PRNGKey(seed)
    return _np64(ref.init_params(key)), tuple(np.asarray(a, np.float64)
                                              for a in ref.make_data(key))


def test_latent_ode_main_matches_reference(latent_ref):
    params_np, (t_np, x_np) = _latent_inputs(latent_ref, 0)
    with jax.enable_x64(True):
        t_obs, x_obs = jnp.asarray(t_np), jnp.asarray(x_np)

        def loss_fn(p):
            z0 = x_obs[:, 0, :] @ p["enc_w"]
            sol = J.solve_ivp_scan(latent_ref.dynamics, z0, t_obs, args=p, rtol=1e-3,
                                   atol=1e-4, max_steps=64)
            return jnp.mean((sol.ys @ p["dec_w"] - x_obs) ** 2)

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
        params = jax.tree_util.tree_map(jnp.asarray, params_np)
        m = jax.tree.map(jnp.zeros_like, params)
        want = []
        for _ in range(3):
            mse, g = grad_fn(params)
            m = jax.tree.map(lambda mm, gg: 0.9 * mm + gg, m, g)
            params = jax.tree.map(lambda p, mm: p - 5e-2 * mm, params, m)
            want.append(float(mse))
    got = latent_ode.main("cpu", iters=3,
                          params=convert.example_params_from_numpy("latent_ode", params_np, "cpu"),
                          data=(torch.tensor(t_np), torch.tensor(x_np)))
    np.testing.assert_allclose(got["mse"], want, rtol=1e-8)


def test_latent_ode_service_matches_reference(latent_ref):
    """The first step's served gradients against the reference's service on
    the same requests (its forward requests, the decoder loss's cotangents,
    its gradient requests), float64; the example itself asserts them
    bitwise equal to the port's solo solve, the loss below ``loss0`` and
    ``n_grad_solves == (n_iters + 1) * batch``."""
    params_np, (t_np, x_np) = _latent_inputs(latent_ref, 1)
    batch = x_np.shape[0]
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(jnp.asarray, params_np)
        x0, x1 = jnp.asarray(x_np[:, 0, :]), jnp.asarray(x_np[:, -1, :])
        term = J.ODETerm(lambda t, z, q: jnp.tanh(z @ q["dyn_w1"]) @ q["dyn_w2"],
                         batched=False, batched_args=True)
        drv = J.ScanAdjoint(J.Stepper("dopri5"), max_steps=64, rtol=1e-3, atol=1e-4)
        svc = J.SolveService(max_batch=16, max_delay=None, max_inflight=2)
        dyn = {"dyn_w1": p["dyn_w1"], "dyn_w2": p["dyn_w2"]}
        z0 = x0 @ p["enc_w"]
        spans = [(float(t_np[i, 0]), float(t_np[i, -1])) for i in range(batch)]

        def submit(cls, **kw):
            futs = [svc.submit(cls(f=term, y0=z0[i], t0=a, t1=b, args=dyn, method=drv,
                                   **{k: v[i] for k, v in kw.items()}))
                    for i, (a, b) in enumerate(spans)]
            svc.flush()
            return [f.result() for f in futs]

        z1 = jnp.stack([jnp.asarray(s.ys[0]) for s in submit(J.SolveRequest)])
        gz1 = jax.grad(lambda z: jnp.mean((z @ p["dec_w"] - x1) ** 2))(z1)
        results = submit(J.GradRequest, cotangent=gz1)
        want = {"y0": np.stack([np.asarray(g.y0) for _, g in results]),
                **{k: np.stack([np.asarray(g.args[k]) for _, g in results]) for k in dyn}}
    got = latent_ode.train_through_service(
        2, device="cpu", params=convert.example_params_from_numpy("latent_ode", params_np, "cpu"),
        data=(torch.tensor(t_np), torch.tensor(x_np)))
    for k, w in want.items():
        assert got["served"][k].dtype == torch.float64
        _close(got["served"][k].numpy(), w, 1e-9)
        assert torch.equal(got["served"][k], got["solo"][k])
    assert got["stats"]["n_grad_solves"] == 3 * batch


def test_latent_ode_runs_in_float32():
    out = latent_ode.main("cpu", iters=2)
    assert len(out["mse"]) == 2 and out["mse"][1] < out["mse"][0]
    served = latent_ode.train_through_service(1, device="cpu")
    assert served["losses"][0] == served["loss0"]


# ------------------------------------------------------------- the LM examples

def _reference_argv(name, *cli):
    """The argument list the reference's ``examples/<name>.py`` passes to
    ``repro.launch.train.main`` when run with ``cli``."""
    import sys

    with mock.patch("repro.launch.train.main") as launched, \
            mock.patch.object(sys, "argv", [f"{name}.py", *cli]):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    (argv,), _ = launched.call_args
    return argv


@pytest.mark.parametrize("cli", [(), ("stablelm-3b", "7")])
def test_train_lm_argv_is_the_references(cli):
    assert train_lm.argv(*cli) == _reference_argv("train_lm", *cli)


def test_continuous_depth_lm_argv_is_the_references():
    assert continuous_depth_lm.argv() == _reference_argv("continuous_depth_lm")


def _three_steps_against_reference(cfg, jcfg, argv, main, rtol):
    """The launcher's three steps from the reference's initial state against
    the reference's jitted step on the same batches."""
    flags = dict(zip(argv, argv[1:]))
    lr, batch, seq = float(flags.get("--lr", 1e-3)), int(flags["--batch"]), int(flags["--seq"])
    state_np = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jsteps.init_train_state(jcfg, jax.random.PRNGKey(0)))())
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, JAdamWConfig(lr=lr, warmup_steps=10, total_steps=3), remat="--remat" in argv))
    jstate, want = jax.tree_util.tree_map(jnp.asarray, state_np), []
    ds = SyntheticTokens(vocab=jcfg.vocab, seq_len=seq, global_batch=batch)
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in ds.batch(i).items()})
        want.append(float(jm["loss"]))
    start = lambda c, seed, **kw: convert.train_state_from_numpy(cfg, state_np, "cpu")
    with mock.patch.object(tlaunch, "init_train_state", start):
        out = main()
    np.testing.assert_allclose(out["losses"], want, rtol=rtol)
    return out


def test_train_lm_three_steps_match_reference(tmp_path):
    cfg, jcfg = get_config("qwen2.5-14b", reduced=True), jget_config("qwen2.5-14b", reduced=True)
    argv = train_lm.argv("qwen2.5-14b", 3, str(tmp_path))
    out = _three_steps_against_reference(
        cfg, jcfg, argv, lambda: train_lm.main("qwen2.5-14b", 3, "cpu", str(tmp_path)), 1e-5)
    assert out["start"] == 0 and (tmp_path / "step_00000002").exists()


def test_continuous_depth_lm_three_steps_match_reference():
    ode = lambda c: dataclasses.replace(c, ode_depth=True, n_layers=len(c.pattern))
    cfg = ode(get_config("stablelm-3b", reduced=True))
    jcfg = ode(jget_config("stablelm-3b", reduced=True))
    out = _three_steps_against_reference(
        cfg, jcfg, continuous_depth_lm.argv(3),
        lambda: continuous_depth_lm.main("cpu", iters=3), 1e-4)
    assert all(m["ode_steps"] > 0 for m in out["metrics"])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_train_lm_trains_the_frontend_configs(arch, tmp_path):
    out = train_lm.main(arch, 2, "cpu", str(tmp_path))
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llava-next-34b"])
def test_launcher_feeds_the_frontends_under_a_mesh(arch):
    """``--fsdp`` on a group of one (a (1, 1) mesh): the frontend embeddings
    go in as DTensors of the batch's placements, and the losses are the
    unsharded run's."""
    argv = ["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--log-every", "100"]
    plain = tlaunch.run(tlaunch.parser().parse_args(argv))["losses"]
    meshed = tlaunch.run(tlaunch.parser().parse_args(argv + ["--fsdp"]))
    assert meshed["mesh"] is not None and not torch.distributed.is_initialized()
    np.testing.assert_allclose(meshed["losses"], plain, rtol=1e-5)


def test_frontend_embeddings_are_the_same_on_every_call():
    cfg = get_config("llava-next-34b", reduced=True)
    a, b = (tlaunch.frontend_batch(cfg, 2, 16, 3, 0) for _ in range(2))
    assert set(a) == {"img_embeds"} and torch.equal(a["img_embeds"], b["img_embeds"])
    assert tlaunch.frontend_batch(get_config("qwen2.5-14b", reduced=True), 2, 16, 0, 0) == {}


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main()


def test_run_examples_times_a_fresh_train_lm_run(tmp_path, monkeypatch, capsys):
    """``tools.run_examples`` gives train_lm a new checkpoint directory under
    the temporary directory, removed after the run, and refuses a run that
    resumed from a checkpoint (it would not be the full-length run it times)."""
    import json
    import tempfile

    from repro_torch.tools import run_examples

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []

    def fake_main(device, ckpt_dir, start=0):
        seen.append(ckpt_dir)
        return {"losses": [2.0, 1.0], "start": start}

    monkeypatch.setattr(run_examples.train_lm, "main",
                        lambda device, ckpt_dir: fake_main(device, ckpt_dir))
    run_examples.main(["--device", "cpu", "--only", "train_lm"])
    (line,) = capsys.readouterr().out.splitlines()
    assert json.loads(line)["start"] == 0
    (made,) = seen
    assert pathlib.Path(made).parent == tmp_path and not pathlib.Path(made).exists()

    monkeypatch.setattr(run_examples.train_lm, "main",
                        lambda device, ckpt_dir: fake_main(device, ckpt_dir, start=150))
    with pytest.raises(SystemExit, match="resumed at step 150"):
        run_examples.main(["--device", "cpu", "--only", "train_lm", "--ckpt-dir",
                           str(tmp_path / "old")])
