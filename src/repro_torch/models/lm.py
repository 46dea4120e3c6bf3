"""Top-level LM: embedding, one ``Block`` per layer, tied unembedding, and
for an encoder-decoder config the encoder stack (the JAX package's
``models/lm.py``).

Entry points, as the reference's (which are pure functions of (cfg,
params, ...)); here ``params`` is an ``LM`` module:

  init_params(cfg, seed, device)        -> LM, weights drawn from the seed
  forward(cfg, params, batch, *, remat) -> (logits, aux)      [train]
  prefill(cfg, params, batch)           -> (last_logits, cache)
  init_cache / pad_cache                -> caches
  decode_step(cfg, params, token, pos, cache) -> (logits, cache)

``batch`` is a dict: tokens (b, s) integer, plus the frontends' stand-ins
(``frontends.py``): img_embeds (b, n_img, d) for a config with image
tokens, audio_embeds (b, s_enc, d) for an encoder-decoder config.  The
caches keep the reference's layout: per position ``i`` of the block
pattern, ``cache[f"b{i}"]`` holds this kind's state stacked on a leading
period axis: ``{"k", "v"}`` of shape (n_periods, b, S, KV * hd) for
attention (and ``{"xk", "xv"}`` over the encoder's length for cross
attention), ``{"h", "conv"}`` for Mamba, ``{"C", "n", "m"}`` for mLSTM,
``{"c", "n", "h", "m"}`` for sLSTM.  ``decode_step`` updates the cache in
place (a new KV row, the next recurrent state) and returns the same cache.
Everything runs on the LM's device (``cuda`` unless the caller asks for
``cpu``).  ``forward`` is the training forward and differentiates (the
attention through its CUDA backward on the card) and returns
``{"moe_balance"}``, the sum over the MoE layers, for a config with a MoE;
``prefill`` and ``decode_step`` run without grad.  With ``cfg.ode_depth``
the forward is ``node.forward_ode``.

Under a mesh (the parameters DTensors placed by
``distributed.sharding.param_shardings``, the batch by ``batch_spec``,
inside ``distributed.constraints.activation_sharding``) the same code runs
sharded: the residual stream is anchored batch-on-dp, d_model replicated,
at the reference's sites (after the embedding, at the top of each period --
inside the checkpointed period under remat -- and the logits vocab-on-tp),
and the caches come back as DTensors.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.constraints import as_dtensor, constrain, rows, shard_index
from . import ssm, xlstm
from .common import apply_norm, dense_fill_, norm_params
from .config import ArchConfig
from .node import forward_ode
from .transformer import Block, _params, check_kind


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def embed_lookup(embed, tokens):
    """``embed[tokens]``.  Under a mesh (a DTensor table, vocab rows on
    "model", d on the data dims with FSDP) each rank looks up its own
    vocab rows in the table gathered over the data dims, zero for a token
    outside them, and the sum over the vocab's mesh dims is the
    ``Partial()`` output (the vocab-parallel embedding; DTensor's own
    index strategy does not hold for every placement in every torch)."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    mesh = embed.device_mesh
    vocab = [i for i, p in enumerate(embed.placements) if isinstance(p, Shard) and p.dim == 0]
    table_pl = tuple(p if i in vocab else Replicate() for i, p in enumerate(embed.placements))
    tok_pl = rows(mesh, tokens.shape)
    out_pl = tuple(Partial() if i in vocab else p for i, p in enumerate(tok_pl))
    # the table's gradient: its vocab rows on "model", partial sums over the
    # ranks that hold other tokens
    grad_pl = tuple(p if i in vocab else Partial() if isinstance(tok_pl[i], Shard)
                    else Replicate() for i, p in enumerate(table_pl))
    block = shard_index(mesh, vocab)

    def local(table, tok):
        idx = tok.long() - block * table.shape[0]
        inside = (idx >= 0) & (idx < table.shape[0])
        out = table[torch.clamp(idx, 0, table.shape[0] - 1)]
        return out * inside[..., None].to(out.dtype)

    return local_map(local, out_placements=list(out_pl), in_placements=(table_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(embed, as_dtensor(tokens, mesh))


class LM(nn.Module):
    """The language model of ``cfg`` on ``device``.  With ``seed`` the
    weights are drawn by ``init_params(seed)``; with ``seed=None`` they are
    left uninitialized, for ``load_state_dict``
    (``convert.lm_params_from_numpy``).  Every weight is a parameter that
    requires grad: ``forward`` trains (``train.steps.make_train_step``),
    ``prefill`` and ``decode_step`` serve.  An encoder-decoder config also
    has ``enc_blocks`` (one ``attn_bidir_mlp`` a period) and
    ``enc_final_norm``."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", seed=None):
        super().__init__()
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
        if cfg.enc_dec:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, "attn_bidir_mlp", device=device, dtype=dtype)
                for _ in range(cfg.n_periods))
            self.enc_final_norm = _params(norm_params(cfg, cfg.d_model, device))
        if seed is not None:
            self.init_params(seed)

    @torch.no_grad()
    def init_params(self, seed=0):
        """Draw every weight on the LM's device from
        ``torch.Generator(device).manual_seed(seed)`` at the reference's
        ``dense_init`` scale (1/sqrt(fan_in); the embedding's fan-in is
        d_model): the embedding, then each layer in order, then the
        encoder's.  Returns the LM."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        dense_fill_(self.embed, g, in_axis=-1)
        for blk in self.blocks:
            blk.init_params(g)
        for blk in getattr(self, "enc_blocks", ()):
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
        x = embed_lookup(self.embed, batch["tokens"])
        if cfg.n_img_tokens > 0 and "img_embeds" in batch:
            x = constrain(x, "dp", None, None)  # a mesh's lookup sums over "model" first
            n = cfg.n_img_tokens
            img = batch["img_embeds"].to(x.dtype)
            x = torch.cat([img, x[:, n:, :]], dim=1)
        return x

    @staticmethod
    def _positions(x):
        b, s, _ = x.shape
        return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    def _run_enc_stack(self, batch):
        """The encoder over ``batch["audio_embeds"]`` (``_run_enc_stack``),
        or None for a decoder-only config."""
        if not self.cfg.enc_dec:
            return None
        x = batch["audio_embeds"].to(self.embed.dtype)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
        for blk in self.enc_blocks:
            x, _, _ = blk.apply_seq(x, positions, mode="train")
        return apply_norm(self.cfg, x, self.enc_final_norm, "")

    def _prefill_stack(self, x, enc_out):
        """The layers in prefill mode: (x, the caches stacked by period)."""
        positions = self._positions(x)
        caches = {}
        for period, i, blk in self._layers():
            if i == 0:
                x = constrain(x, "dp", None, None)
            x, cache, _ = blk.apply_seq(x, positions, mode="prefill", enc_out=enc_out)
            for name, t in cache.items():
                caches.setdefault(f"b{i}", {}).setdefault(name, []).append(t)
        return x, {key: {name: torch.stack(ts) for name, ts in c.items()}
                   for key, c in caches.items()}

    def forward(self, batch, *, remat=False):
        """Training forward: (logits (b, s, vocab), aux losses dict), under
        the caller's grad mode; aux is ``{"moe_balance"}`` (summed over the
        layers in order) for a config with a MoE, else empty.  ``remat``
        checkpoints each period (``torch.utils.checkpoint``, non-reentrant):
        only the period inputs are kept and the period is recomputed in the
        backward, as the reference wraps each period in ``jax.checkpoint``.
        With ``cfg.ode_depth`` the stack is one weight-tied block integrated
        in depth (``node.forward_ode``)."""
        cfg = self.cfg
        if cfg.ode_depth:
            return forward_ode(cfg, self, batch)
        x = constrain(self._embed_tokens(batch), "dp", None, None)
        positions = self._positions(x)
        enc_out = self._run_enc_stack(batch)
        n = len(cfg.pattern)

        def period(x, aux, p):
            # anchor the residual stream: batch on dp, d_model replicated (see
            # distributed/constraints.py -- keeps FSDP weight shardings out of
            # the activations)
            x = constrain(x, "dp", None, None)
            for blk in self.blocks[p * n:(p + 1) * n]:
                x, _, block_aux = blk.apply_seq(x, positions, mode="train", enc_out=enc_out)
                for key, value in block_aux.items():
                    aux = {**aux, key: aux[key] + value}
            return x, aux

        aux = {}
        if cfg.moe is not None:
            aux = {"moe_balance": torch.zeros((), dtype=torch.float32, device=x.device)}
        for p in range(cfg.n_periods):
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(period, x, aux, p, use_reentrant=False)
            else:
                x, aux = period(x, aux, p)
        x = apply_norm(cfg, x, self.final_norm, "")
        return constrain(x @ self.embed.T, "dp", None, "tp"), aux

    @torch.no_grad()
    def prefill(self, batch):
        """Full-sequence forward that materializes caches: (last_logits, cache)."""
        x = constrain(self._embed_tokens(batch), "dp", None, None)
        x, caches = self._prefill_stack(x, self._run_enc_stack(batch))
        x = apply_norm(self.cfg, x[:, -1:, :], self.final_norm, "")[:, 0]
        return constrain(x @ self.embed.T, "dp", "tp"), caches

    def init_cache(self, batch_size: int, cache_len: int, enc_len: int | None = None):
        """Zero caches for decode-from-scratch, on the LM's device."""
        return init_cache(self.cfg, batch_size, cache_len, device=self.device, enc_len=enc_len)

    def pad_cache(self, cache, cache_len: int):
        return pad_cache(self.cfg, cache, cache_len)

    @torch.no_grad()
    def decode_step(self, token, pos, cache):
        """One decode step.  token: (b,) integer; pos: (b,) positions.
        Returns (logits (b, vocab), cache), the cache updated in place."""
        x = constrain(embed_lookup(self.embed, token), "dp", None)  # (b, d)
        for period, i, blk in self._layers():
            if i == 0:
                x = constrain(x, "dp", None)
            layer_cache = cache[f"b{i}"]
            x, _ = blk.apply_decode(x, pos, {name: t[period] for name, t in layer_cache.items()})
        x = apply_norm(self.cfg, x[:, None, :], self.final_norm, "")[:, 0]
        return constrain(x @ self.embed.T, "dp", "tp"), cache


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


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int, device="cuda",
               enc_len: int | None = None):
    """Zero caches for decode-from-scratch, as the reference's: KV caches in
    the config's dtype (the cross attention's of ``enc_len``, by default
    ``cache_len``), recurrent states in their init states' shapes and
    dtypes but all zero (the reference zeroes the -1e30 of ``m`` too)."""
    dtype, device = getattr(torch, cfg.dtype), _device(device)
    Dkv = cfg.n_kv_heads * cfg.hd  # flat head dim
    caches = {}
    for i, kind in enumerate(cfg.pattern):
        if kind in ("attn_mlp", "attn_moe", "attn_cross_mlp"):
            kv = torch.empty((batch_size, cache_len, Dkv), dtype=dtype, device="meta")
            c = {"k": kv, "v": kv}
            if kind == "attn_cross_mlp":
                xkv = torch.empty((batch_size, enc_len or cache_len, Dkv), dtype=dtype,
                                  device="meta")
                c.update(xk=xkv, xv=xkv)
        elif kind in ("mamba_mlp", "mamba_moe"):
            c = ssm.mamba_init_state(cfg, batch_size, dtype, "meta")
        elif kind == "mlstm":
            c = xlstm.mlstm_init_state(cfg, batch_size, "meta")
        elif kind == "slstm":
            c = xlstm.slstm_init_state(cfg, batch_size, device="meta")
        else:
            raise ValueError(kind)
        caches[f"b{i}"] = {name: torch.zeros((cfg.n_periods, *t.shape), dtype=t.dtype,
                                             device=device) for name, t in c.items()}
    return caches


def pad_cache(cfg: ArchConfig, cache, cache_len: int):
    """Grow the self-attention KV caches (from prefill, length s) to
    ``cache_len`` so decode can continue past the prefill length (new
    tensors; the input is left as it is).  The cross attention's and the
    recurrent states pass through."""
    out = {}
    for key, c in cache.items():
        out[key] = dict(c)
        for name in ("k", "v"):
            extra = cache_len - c[name].shape[2] if name in c else 0
            if extra > 0:
                out[key][name] = _pad_dim2(c[name], extra)
    return out


def _pad_dim2(t, extra):
    """``t`` (L, b, S, D) zero-padded to S + extra; a DTensor on its own
    shards (S is never sharded)."""
    if isinstance(t, DTensor):
        return DTensor.from_local(_pad_dim2(t.to_local(), extra), t.device_mesh, t.placements,
                                  run_check=False)
    return torch.nn.functional.pad(t, (0, 0, 0, extra))


def decode_step(cfg: ArchConfig, params, token, pos, cache):
    return _model(cfg, params).decode_step(token, pos, cache)
