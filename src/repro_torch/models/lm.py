"""Top-level LM: embedding, one ``Block`` per layer, tied unembedding (the
JAX package's ``models/lm.py``).

Entry points, as the reference's (which are pure functions of (cfg,
params, ...)); here ``params`` is an ``LM`` module:

  init_params(cfg, seed, device)        -> LM, weights drawn from the seed
  forward(cfg, params, batch, *, remat) -> (logits, aux)      [train]
  prefill(cfg, params, batch)           -> (last_logits, cache)
  init_cache / pad_cache                -> caches
  decode_step(cfg, params, token, pos, cache) -> (logits, cache)

``batch`` is a dict: tokens (b, s) integer, and img_embeds (b, n_img, d)
for a config with image tokens.  The caches keep the reference's layout: per
position ``i`` of the block pattern, ``cache[f"b{i}"] = {"k", "v"}`` of shape
(n_periods, b, S, KV * hd).  ``decode_step`` writes the new row of each
cache in place and returns the same cache.  Everything runs on the LM's
device (``cuda`` unless the caller asks for ``cpu``).  ``forward`` is the
training forward and differentiates (the attention through its CUDA
backward on the card); ``prefill`` and ``decode_step`` run without grad.
With ``cfg.ode_depth`` the forward is ``node.forward_ode``.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from .common import apply_norm, dense_fill_, norm_params
from .config import ArchConfig
from .node import forward_ode
from .transformer import Block, _params, check_kind


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class LM(nn.Module):
    """The language model of ``cfg`` on ``device``.  With ``seed`` the
    weights are drawn by ``init_params(seed)``; with ``seed=None`` they are
    left uninitialized, for ``load_state_dict``
    (``convert.lm_params_from_numpy``).  Every weight is a parameter that
    requires grad: ``forward`` trains (``train.steps.make_train_step``),
    ``prefill`` and ``decode_step`` serve."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", seed=None):
        super().__init__()
        if cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder models are not ported yet (ROADMAP A-17)")
        for kind in cfg.pattern:
            check_kind(kind)
        device = _device(device)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.embed = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model), dtype=dtype,
                                              device=device))
        self.final_norm = _params(norm_params(cfg, cfg.d_model, device))
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.pattern[i % len(cfg.pattern)], device=device, dtype=dtype)
            for i in range(cfg.n_layers))
        if seed is not None:
            self.init_params(seed)

    @torch.no_grad()
    def init_params(self, seed=0):
        """Draw every weight on the LM's device from
        ``torch.Generator(device).manual_seed(seed)`` at the reference's
        ``dense_init`` scale (1/sqrt(fan_in); the embedding's fan-in is
        d_model): the embedding, then each layer in order.  Returns the LM."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        dense_fill_(self.embed, g, in_axis=-1)
        for blk in self.blocks:
            blk.init_params(g)
        return self

    @property
    def device(self):
        return self.embed.device

    def _layers(self):
        """(period, pattern position, block) in layer order."""
        n = len(self.cfg.pattern)
        return ((layer // n, layer % n, blk) for layer, blk in enumerate(self.blocks))

    def _embed_tokens(self, batch):
        cfg = self.cfg
        x = self.embed[batch["tokens"]]
        if cfg.n_img_tokens > 0 and "img_embeds" in batch:
            n = cfg.n_img_tokens
            img = batch["img_embeds"].to(x.dtype)
            x = torch.cat([img, x[:, n:, :]], dim=1)
        return x

    def _prefill_stack(self, x):
        """The layers in prefill mode: (x, the caches stacked by period)."""
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        caches = {}
        for period, i, blk in self._layers():
            x, cache, _ = blk.apply_seq(x, positions, mode="prefill")
            if cache is not None:
                c = caches.setdefault(f"b{i}", {
                    name: torch.empty((self.cfg.n_periods, *t.shape), dtype=t.dtype,
                                      device=t.device) for name, t in cache.items()})
                for name, t in cache.items():
                    c[name][period] = t
        return x, caches

    def forward(self, batch, *, remat=False):
        """Training forward: (logits (b, s, vocab), aux losses dict), under
        the caller's grad mode.  ``remat`` checkpoints each period
        (``torch.utils.checkpoint``, non-reentrant): only the period inputs
        are kept and the period is recomputed in the backward, as the
        reference wraps each period in ``jax.checkpoint``.  With
        ``cfg.ode_depth`` the stack is one weight-tied block integrated in
        depth (``node.forward_ode``)."""
        cfg = self.cfg
        if cfg.ode_depth:
            return forward_ode(cfg, self, batch)
        x = self._embed_tokens(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        n = len(cfg.pattern)

        def period(x, p):
            for blk in self.blocks[p * n:(p + 1) * n]:
                x, _, _ = blk.apply_seq(x, positions, mode="train")
            return x

        for p in range(cfg.n_periods):
            if remat:
                x = torch.utils.checkpoint.checkpoint(period, x, p, use_reentrant=False)
            else:
                x = period(x, p)
        x = apply_norm(cfg, x, self.final_norm, "")
        return x @ self.embed.T, {}

    @torch.no_grad()
    def prefill(self, batch):
        """Full-sequence forward that materializes caches: (last_logits, cache)."""
        x, caches = self._prefill_stack(self._embed_tokens(batch))
        x = apply_norm(self.cfg, x[:, -1:, :], self.final_norm, "")[:, 0]
        return x @ self.embed.T, caches

    def init_cache(self, batch_size: int, cache_len: int):
        """Zero caches for decode-from-scratch, on the LM's device."""
        return init_cache(self.cfg, batch_size, cache_len, device=self.device)

    def pad_cache(self, cache, cache_len: int):
        return pad_cache(self.cfg, cache, cache_len)

    @torch.no_grad()
    def decode_step(self, token, pos, cache):
        """One decode step.  token: (b,) integer; pos: (b,) positions.
        Returns (logits (b, vocab), cache), the cache updated in place."""
        x = self.embed[token]  # (b, d)
        for period, i, blk in self._layers():
            layer_cache = cache[f"b{i}"]
            x, _ = blk.apply_decode(x, pos, {name: t[period] for name, t in layer_cache.items()})
        x = apply_norm(self.cfg, x[:, None, :], self.final_norm, "")[:, 0]
        return x @ self.embed.T, cache


def _model(cfg, params):
    if not isinstance(params, LM):
        raise TypeError(f"expected an LM module, got {type(params).__name__}")
    if params.cfg != cfg:
        raise ValueError(f"the LM was built for {params.cfg.name}, not {cfg.name}")
    return params


def init_params(cfg: ArchConfig, seed=0, device="cuda") -> LM:
    return LM(cfg, device=device, seed=seed)


def param_count(params) -> int:
    return sum(p.numel() for p in params.parameters())


def forward(cfg: ArchConfig, params, batch, *, remat: bool = False):
    """Training forward: returns (logits (b, s, vocab), aux losses dict)."""
    return _model(cfg, params).forward(batch, remat=remat)


def prefill(cfg: ArchConfig, params, batch):
    return _model(cfg, params).prefill(batch)


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, device="cuda"):
    """Zero caches for decode-from-scratch, in the config's dtype."""
    shape = (cfg.n_periods, batch_size, cache_len, cfg.n_kv_heads * cfg.hd)
    dtype, device = getattr(torch, cfg.dtype), _device(device)
    return {f"b{i}": {name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("k", "v")}
            for i in range(len(cfg.pattern))}


def pad_cache(cfg: ArchConfig, cache, cache_len: int):
    """Grow the KV caches (from prefill, length s) to ``cache_len`` so
    decode can continue past the prefill length (new tensors; the input is
    left as it is)."""
    out = {}
    for key, c in cache.items():
        out[key] = dict(c)
        for name in ("k", "v"):
            extra = cache_len - c[name].shape[2] if name in c else 0
            if extra > 0:
                out[key][name] = torch.nn.functional.pad(c[name], (0, 0, 0, extra))
    return out


def decode_step(cfg: ArchConfig, params, token, pos, cache):
    return _model(cfg, params).decode_step(token, pos, cache)
