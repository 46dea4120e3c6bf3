"""Shared building blocks: norms, RoPE, initializers (the JAX package's
``models/common.py``), the ``jax.nn`` functions whose torch counterparts
differ (``softplus``, ``log_sigmoid``), and ``Params``, a sub-layer's
weights by name.  Norms and RoPE compute in float32 and cast back to the
input's dtype, as the reference does."""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)  # jnp.var's two passes
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg, x, p, prefix):
    """The config's norm with the parameters ``p[prefix + "_scale"]`` (and
    ``"_bias"``); ``p`` is any mapping of tensors (a ``ParameterDict``)."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p[f"{prefix}_scale"])
    return layernorm(x, p[f"{prefix}_scale"], p[f"{prefix}_bias"])


def norm_params(cfg, d, device=None):
    """A norm's parameters, float32 as in the reference: scale ones (and
    bias zeros for layernorm)."""
    p = {"_scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm != "rmsnorm":
        p["_bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def rope_freqs(hd: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=None)
def _device_freqs(hd, theta, device):
    """``rope_freqs`` on ``device``, copied there once: a copy per call would
    be a host-to-device transfer, which waits for the queued work, in every
    layer of every decode step."""
    return torch.as_tensor(rope_freqs(hd, theta), device=device)


def apply_rope(x, positions, theta):
    """x: (..., s, n_heads, hd); positions: (..., s) integer.  The
    split-halves rotation, in float32."""
    hd = x.shape[-1]
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
        freqs = _device_freqs(hd, float(theta), x.device)  # (hd/2,)
    else:  # fake tensors (the dry run's) stay out of the cache
        freqs = torch.as_tensor(rope_freqs(hd, float(theta)), device=x.device)
    angles = positions[..., None].float() * freqs  # (..., s, hd/2)
    sin = torch.sin(angles)[..., None, :]  # (..., s, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_fill_(t, generator, in_axis=-2):
    """Fill ``t`` in place with normal entries of standard deviation
    1/sqrt(fan_in), fan_in = ``t.shape[in_axis]``, drawn from ``generator``
    (which must live on ``t``'s device): drawn in ``t``'s dtype and then
    scaled, as the reference multiplies ``jax.random.normal(key, shape,
    dtype)`` by the weak-typed scale."""
    std = float(1.0 / np.sqrt(t.shape[in_axis]))
    return t.normal_(generator=generator).mul_(std)


def dense_init(generator, shape, in_axis=-2, dtype=torch.float32, device=None):
    """A new tensor of ``shape`` filled by ``dense_fill_``."""
    return dense_fill_(torch.empty(shape, dtype=dtype, device=device), generator, in_axis)


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


class Params(nn.Module):
    """A sub-layer's weights, each an ``nn.Parameter`` read by name
    (``p["w_in"]``, ``"w_in" in p``) as the reference reads its dicts; a
    module (unlike ``nn.ParameterDict``) so that a subclass can define
    ``forward``.  ``init_params(generator)`` draws every weight named in
    ``dense`` by ``dense_fill_``, in that order."""

    dense: tuple = ()

    def __init__(self, tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    def __getitem__(self, name):
        return self._parameters[name]

    def __contains__(self, name):
        return name in self._parameters

    @torch.no_grad()
    def init_params(self, generator):
        for name in self.dense:
            if name in self:
                dense_fill_(self[name], generator)
        return self
