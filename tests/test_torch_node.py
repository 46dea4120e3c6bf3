"""The port's continuous-depth LM (``models/node.py``: ``forward_ode``)
against the JAX package's, from the same weights and tokens.

Reduced stablelm-3b with ``ode_depth`` (one weight-tied block, each sequence
one ODE instance of s * d float32 entries, bosh3 through ``solve_ivp_scan``
at rtol 1e-2, atol 1e-3, ``cfg.ode_steps`` = 8 iterations): the logits and
``aux["ode_steps"]``, and the gradient of the cross-entropy loss in every
parameter, float32.  Both solves take the same steps here (equal
``ode_steps``), so the logits are held to 1e-4 and each gradient to 1e-4 of
its largest entry: float32 rounding through the block, eight steps of the
solver and the step-size controller (ROADMAP C-5: XLA's and ATen's float32
``pow`` differ by an ulp, which moves the controller's factor by as much).
The same model trains one step through ``make_train_step``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as J  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
import repro_torch.models as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import cross_entropy_loss, make_train_step  # noqa: E402

B, S, TOL = 2, 24, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ode(cfg):
    return dataclasses.replace(cfg, ode_depth=True, n_layers=len(cfg.pattern))


@pytest.fixture(scope="module")
def case():
    jcfg = _ode(jget_config("stablelm-3b", reduced=True))
    cfg = _ode(get_config("stablelm-3b", reduced=True))
    jparams = J.init_params(jcfg, jax.random.PRNGKey(0))
    model = T.LM(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return cfg, jcfg, jparams, model, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_forward_ode_matches_reference(case):
    cfg, jcfg, jparams, model, batch = case
    want, jaux = J.forward(jcfg, jparams, _jbatch(batch))
    with torch.no_grad():
        got, aux = T.forward(cfg, model, _tbatch(batch))
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert float(aux["ode_steps"]) == float(jaux["ode_steps"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_forward_ode_gradient_matches_reference(case):
    cfg, jcfg, jparams, model, batch = case

    def jloss(p):
        logits, _ = J.forward(jcfg, p, _jbatch(batch))
        return jsteps.cross_entropy_loss(logits, jnp.asarray(batch["labels"]))

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    logits, _ = model.forward(_tbatch(batch))
    loss = cross_entropy_loss(logits, torch.as_tensor(batch["labels"]))
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = lm_params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jgrads), "cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * max(np.abs(w).max(), 1e-30), (name, err, np.abs(w).max())


def test_ode_lm_trains_a_step(case):
    cfg, _, _, model, batch = case
    clone = T.LM(cfg, device="cpu")
    clone.load_state_dict(model.state_dict())
    state = {"params": clone, "opt": adamw_init(dict(clone.named_parameters()))}
    step = make_train_step(cfg)
    before = clone.embed.detach().clone()
    state, metrics = step(state, _tbatch(batch))
    assert float(metrics["ode_steps"]) > 0 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, clone.embed)
