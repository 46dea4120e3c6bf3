"""The LM training path on the card: the CUDA attention backward and the
train step.

- ``flash_attention_bwd`` against its plain version on the same card
  tensors by ``tools/attn_checks.hold`` (float32 within 1e-4 of the largest
  entry; bfloat16 within 2x the plain bf16 version's error against a float64
  oracle) over ``attn_checks.CASES`` and both ``LAYERS``, each dtype on the
  body ``flash_bwd_body`` picks (bf16: wgmma) and bf16 on the FFMA body too,
  the forward's ``lse`` within 1e-5 of the plain forward's and its output
  bitwise the same with and without ``lse``; two wgmma calls at
  stablelm-3b's layer bitwise equal;
- ``ops.flash_attention_fwd`` under grad goes through
  ``autograd.FlashAttention``: one forward and one backward launch, the
  gradients those of the plain pair on the card; the raw wrappers refuse
  what the kernels do not take;
- reduced stablelm-3b trains three steps on the card (float32, both
  optimizers, remat on and off) within 1e-4 of the same steps on the CPU,
  with one backward launch per layer per step (and one more forward per
  layer with remat); N steps, or N/2 then a checkpoint then N/2, bitwise
  equal on the card.

These tests need a CUDA device and skip without one; they import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_train_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager, latest_step, restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels import cuda_impl, ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tools import attn_checks  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention backward is a CUDA kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", attn_checks.CASES + list(attn_checks.LAYERS.values()))
def test_backward_against_plain(cuda_device, dtype, case):
    q, k, v, do = attn_checks.inputs(sum(case[:6]), case, dtype, cuda_device)
    before = dict(cuda_impl.body_launches["flash_attention_bwd"])
    attn_checks.hold(str(case), case, dtype, q, k, v, do)
    body = cuda_impl.flash_bwd_body(case[5], dtype)
    assert cuda_impl.body_launches["flash_attention_bwd"][body] == before[body] + 1


@pytest.mark.parametrize("case", attn_checks.CASES + [attn_checks.LAYERS["stablelm-3b_train"]])
def test_ffma_body_in_bf16(cuda_device, case):
    q, k, v, do = attn_checks.inputs(sum(case[:6]), case, torch.bfloat16, cuda_device)
    attn_checks.hold(str(case), case, torch.bfloat16, q, k, v, do, body="ffma")


def test_wgmma_backward_is_bitwise_repeatable(cuda_device):
    """No floating-point atomics: two calls give the same bits."""
    case = attn_checks.LAYERS["stablelm-3b_train"]
    q, k, v, do = attn_checks.inputs(5, case, torch.bfloat16, cuda_device)
    o, lse = cuda_impl.flash_attention_fwd(q, k, v, lse=True)
    first = cuda_impl.flash_attention_bwd(q, k, v, o, lse, do, body="wgmma")
    second = cuda_impl.flash_attention_bwd(q, k, v, o, lse, do, body="wgmma")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_function_on_card(cuda_device):
    case = (2, 37, 45, 4, 2, 16, True, 8)
    q, k, v, do = attn_checks.inputs(3, case, torch.float32, cuda_device)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = dict(ops.launches)
    out = ops.flash_attention_fwd(q, k, v, q_offset=8)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    assert ops.launches["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert ops.launches["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    o, lse = tref.flash_attention_fwd(q.detach(), k.detach(), v.detach(), q_offset=8, lse=True)
    want = tref.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do, q_offset=8)
    assert max(attn_checks.rel_errors(got, want)) <= attn_checks.F32_TOL


def test_bad_inputs_raise(cuda_device):
    q = torch.randn(1, 8, 4, 136, device=cuda_device)
    o, lse = torch.zeros_like(q), torch.zeros(1, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        cuda_impl.flash_attention_bwd(q, q, q, o, lse, o)
    q = q[..., :16].contiguous()
    with pytest.raises(ValueError, match="lse"):
        cuda_impl.flash_attention_bwd(q, q, q, q, lse[..., :4], q)
    with pytest.raises(TypeError, match="expected"):
        cuda_impl.flash_attention_bwd(q, q, q, q, lse.double(), q)
    with pytest.raises(RuntimeError, match="autograd Function"):
        cuda_impl.flash_attention_bwd(q.clone().requires_grad_(), q, q, q, lse, q)
    before = dict(cuda_impl.launches)
    with pytest.raises(ValueError, match="wgmma body"):
        cuda_impl.flash_attention_bwd(q, q, q, q, lse, q, body="wgmma")
    assert cuda_impl.launches == before


def _batches(cfg, n, device):
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=24, global_batch=2)
    return [{k: torch.as_tensor(v, device=device) for k, v in ds.batch(i).items()}
            for i in range(n)]


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_card_vs_cpu(cuda_device, remat, optimizer):
    cfg = get_config("stablelm-3b", reduced=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt, remat=remat, optimizer=optimizer)
    cpu = init_train_state(cfg, 0, optimizer=optimizer, device="cpu")
    card = init_train_state(cfg, 0, optimizer=optimizer, device=cuda_device)
    card["params"].load_state_dict(cpu["params"].state_dict())
    before = dict(ops.launches)
    # the 8-bit update parts from step 2 on (test_torch_train.py: HELD_STEPS)
    n = 3 if optimizer == "adamw" else 1
    for b_cpu, b_card in zip(_batches(cfg, n, "cpu"), _batches(cfg, n, cuda_device)):
        cpu, m_cpu = step(cpu, b_cpu)
        card, m_card = step(card, b_card)
        np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m_card["grad_norm"]), float(m_cpu["grad_norm"]),
                                   rtol=1e-4)
    assert ops.launches["flash_attention_bwd"] - before["flash_attention_bwd"] == n * cfg.n_layers
    assert (ops.launches["flash_attention_fwd"] - before["flash_attention_fwd"]
            == n * cfg.n_layers * (2 if remat else 1))
    for (name, p), (_, w) in zip(card["params"].named_parameters(),
                                 cpu["params"].named_parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(), w.detach().numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_resume_is_bitwise_on_card(cuda_device, tmp_path):
    cfg = get_config("stablelm-3b", reduced=True)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    batches = _batches(cfg, 4, cuda_device)
    straight = init_train_state(cfg, 0, device=cuda_device)
    for b in batches:
        straight, _ = step(straight, b)
    half = init_train_state(cfg, 0, device=cuda_device)
    for b in batches[:2]:
        half, _ = step(half, b)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save_async(1, tlaunch.state_tree(half))
    mgr.close()
    fresh = init_train_state(cfg, 1, device=cuda_device)
    tlaunch.load_state(fresh, restore(str(tmp_path), latest_step(str(tmp_path)),
                                      tlaunch.state_tree(fresh)))
    for b in batches[2:]:
        fresh, _ = step(fresh, b)
    for (name, p), (_, w) in zip(fresh["params"].named_parameters(),
                                 straight["params"].named_parameters()):
        assert torch.equal(p, w), name
    assert isinstance(fresh["params"], LM)
