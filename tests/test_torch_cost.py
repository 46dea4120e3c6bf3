"""The port's cost counter (``repro_torch.launch.cost``), the counterpart of
the JAX package's ``launch/hlocost.py`` (``tests/test_system.py::
TestHloCost``): loop trip counts (a Python loop is unrolled, so every
iteration's matmul is seen), nested loops, bounded bytes; the attention
kernels counted by their formula and not by their plain versions' work;
collective bytes by kind on a fake 2 x 2 process group against the count by
hand; the live-storage high-water mark; no change to what runs outside the
counter.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels import autograd, cuda_impl, ops, ref  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.tools import cost_checks  # noqa: E402

MM = 2 * 8 * 64 * 64


@pytest.fixture(params=["real", "fake"])
def mode(request):
    """Run the case on real CPU tensors, or under ``FakeTensorMode``."""
    if request.param == "fake":
        with FakeTensorMode():
            yield request.param
    else:
        yield request.param


def test_counts_loop_trip_counts(mode):
    def g(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    r = cost.analyze(g, torch.randn(8, 64), torch.randn(64, 64))
    assert r["flops"] == 7 * MM


def test_nested_loops(mode):
    def h(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    assert cost.analyze(h, torch.randn(8, 64), torch.randn(64, 64))["flops"] == 15 * MM


def test_bytes_are_positive_and_bounded(mode):
    r = cost.analyze(lambda a: a @ a.T, torch.randn(64, 64))
    assert 0 < r["bytes"] < 64 * 64 * 4 * 100


@pytest.mark.parametrize("missing", ["propagation", "strided"])
def test_missing_dtensor_internals_raise(missing, monkeypatch):
    """The counter leans on private DTensor names; a torch without them makes
    ``analyze`` raise instead of counting DTensor's shape propagation as the
    step's work."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if missing == "propagation":
        for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
            monkeypatch.delattr(ShardingPropagator, name, raising=False)
    else:
        monkeypatch.delattr(placement_types._StridedShard, "local_shard_size_and_offset")
    with pytest.raises(RuntimeError, match="_StridedShard|ShardingPropagator"):
        cost.analyze(lambda x: x @ x, torch.randn(4, 4))


@pytest.mark.parametrize("sq,sk,q_offset", [(7, 7, 0), (5, 9, 4), (9, 5, 0), (3, 9, 20)])
def test_visible_pairs_by_hand(sq, sk, q_offset):
    mask = np.arange(sk)[None, :] <= q_offset + np.arange(sq)[:, None]
    assert cost.visible_pairs(sq, sk, True, q_offset) == int(mask.sum())
    assert cost.visible_pairs(sq, sk, False, q_offset) == sq * sk


FLASH = dict(b=2, sq=96, sk=96, H=4, KV=2, hd=16)


def _qkv(requires_grad=False, **kw):
    s = {**FLASH, **kw}
    q = torch.randn(s["b"], s["sq"], s["H"], s["hd"], requires_grad=requires_grad)
    k, v = (torch.randn(s["b"], s["sk"], s["KV"], s["hd"], requires_grad=requires_grad)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_by_formula(causal):
    """4 b H hd a visible pair, on fake tensors; the plain version (blocks of
    16 x 16, every block of S, the keys padded to a block) counts more."""
    with FakeTensorMode():
        q, k, v = _qkv(sk=96 if causal else 90)
        kw = dict(causal=causal, q_chunk=16, kv_chunk=16)
        r = cost.analyze(lambda q, k, v: ops.flash_attention_fwd(q, k, v, **kw), q, k, v)
        plain = cost.CostCounter()
        with plain:
            ref.flash_attention_fwd(q, k, v, **kw)
    b, sq, H, hd = q.shape
    pairs = cost.visible_pairs(sq, k.shape[1], causal)
    assert r["flops"] == 4 * b * H * hd * pairs
    assert plain.flops > r["flops"]
    assert r["bytes"] == 4 * (2 * q.numel() + 2 * k.numel())
    assert r["result"].shape == q.shape


def test_flash_backward_by_formula():
    """The training path (``autograd.FlashAttention``): 4 + 10 b H hd a
    visible pair, causal with a query offset."""
    with FakeTensorMode():
        q, k, v = _qkv(requires_grad=True, sq=40, sk=72)

        def fwd_bwd(q, k, v):
            o = ops.flash_attention_fwd(q, k, v, causal=True, q_offset=32, q_chunk=16,
                                        kv_chunk=16)
            return torch.autograd.grad(o.sum(), (q, k, v))

        r = cost.analyze(fwd_bwd, q, k, v)
    b, sq, H, hd = q.shape
    pairs = cost.visible_pairs(sq, 72, True, 32)
    assert r["flops"] == 14 * b * H * hd * pairs
    assert [g.shape for g in r["result"]] == [q.shape, k.shape, v.shape]


def test_flash_on_real_tensors_is_unchanged():
    """On real tensors the plain versions run, uncounted, and give what they
    give outside the counter; the kernels' launch counts do not move."""
    q, k, v = _qkv(requires_grad=True)
    before = dict(cuda_impl.launches)
    want = autograd.flash_attention(q, k, v, causal=True, q_offset=0, q_chunk=16, kv_chunk=16)
    gwant = torch.autograd.grad(want.sum(), (q, k, v))

    def fwd_bwd(q, k, v):
        o = ops.flash_attention_fwd(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
        return o, torch.autograd.grad(o.sum(), (q, k, v))

    r = cost.analyze(fwd_bwd, q, k, v)
    got, ggot = r["result"]
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(ggot, gwant))
    b, sq, H, hd = q.shape
    assert r["flops"] == 14 * b * H * hd * cost.visible_pairs(sq, sq, True)
    assert dict(cuda_impl.launches) == before
    assert ref.flash_attention_fwd.__module__ == ref.__name__  # the patch is gone


def test_collective_bytes_by_kind():
    """A Shard(1) matmul and its backward on a fake 2 x 2 group
    (``cost_checks.sharded_matmul``): collective bytes by kind, FLOPs and
    argument bytes equal to the count by hand."""
    got, want = cost_checks.sharded_matmul()
    assert got == want


def test_peak_is_the_live_high_water_mark(mode):
    n = 1000

    def h(x):
        kept = [x + i for i in range(4)]  # four live at once
        del kept
        return x * 2  # one more, after they are freed

    r = cost.analyze(h, torch.zeros(n))
    assert r["argument"] == 4 * n
    assert r["peak"] == 4 * n + 4 * 4 * n


def test_a_fake_run_leaves_no_fake_tensor_in_the_rope_cache():
    """A step counted on fake tensors (the dry run) caches nothing that a real
    run reads afterwards: RoPE's frequencies (``common._device_freqs``, per
    (hd, theta, device)) made under the fake mode would be fake, and a later
    real run of a config with the same key would rotate by them."""
    from repro_torch.models import common

    x = torch.randn(1, 5, 2, 16)
    pos = torch.arange(5)[None]
    common._device_freqs.cache_clear()
    want = common.apply_rope(x, pos, 10000.0)
    common._device_freqs.cache_clear()
    cost_checks.prefill_flops()  # reduced stablelm-3b: hd 16, theta 1e4
    assert common._device_freqs.cache_info().currsize == 0
    assert torch.equal(common.apply_rope(x, pos, 10000.0), want)
