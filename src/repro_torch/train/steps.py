"""Step functions (the JAX package's ``train/steps.py``): the training step
(forward, backward, global-norm clipping and AdamW) and the two serve steps
(prefill, decode).

The reference's steps are pure functions of (state, batch) that ``jax.jit``
compiles (under a mesh, with the state's and batch's shardings).  Here the
state is ``{"params": LM, "opt": {"m", "v", "step"}}`` and the step updates
it in place (the weights and moments are the card's largest buffers) and
returns it with the metrics, which stay on the device.  Under a mesh
(``distributed``) the state and batch are DTensors and the step runs inside
the launcher's ``activation_sharding``; the metrics come back as plain
tensors.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.constraints import as_dtensor, shard_index
from ..models import decode_step as model_decode
from ..models import forward, init_params, prefill
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..optim.adamw import AdamWConfig
from ..optim.quantized import qadamw_init, qadamw_update


def _gold_on_shards(lf, labels):
    """The gold logits of vocab-sharded DTensor logits (b, s, V): DTensor
    has no sharding strategy for ``take_along_dim`` over a sharded dim, so
    each rank reads the labels that fall in its vocab slice (zero
    elsewhere) and the sum over the vocab's mesh dims is the ``Partial()``
    output."""
    mesh = lf.device_mesh
    vocab_dims = [i for i, p in enumerate(lf.placements) if isinstance(p, Shard) and p.dim == 2]
    lab_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in lf.placements)
    out_pl = tuple(Partial() if i in vocab_dims else p for i, p in enumerate(lab_pl))
    block = shard_index(mesh, vocab_dims)

    def local(lf_l, lab_l):
        V_l = lf_l.shape[-1]
        idx = lab_l.long() - block * V_l
        inside = (idx >= 0) & (idx < V_l)
        g = torch.take_along_dim(lf_l, torch.clamp(idx, 0, V_l - 1)[..., None], dim=-1)[..., 0]
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))

    return local_map(local, out_placements=list(out_pl), in_placements=(lf.placements, lab_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        lf, as_dtensor(labels, mesh))


def cross_entropy_loss(logits, labels, mask=None):
    """Stable cross entropy over the vocab axis in float32; with ``mask``
    the masked mean.  Vocab-sharded DTensor logits (under a mesh) take
    their gold logits on their own shards."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if isinstance(lf, DTensor):
        gold = _gold_on_shards(lf, labels)
    else:
        gold = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def init_train_state(cfg, seed=0, *, optimizer: str = "adamw", device="cuda"):
    """A new LM drawn from ``seed`` on ``device`` and its optimizer state
    (``"adamw"``: float32 moments; ``"adamw8bit"``: blockwise int8)."""
    params = init_params(cfg, seed, device)
    init = qadamw_init if optimizer == "adamw8bit" else adamw_init
    return {"params": params, "opt": init(dict(params.named_parameters()))}


def make_train_step(cfg, opt_cfg: AdamWConfig | None = None, *, moe_aux_weight=0.01,
                    remat: bool = False, optimizer: str = "adamw"):
    """``train_step(state, batch, *, timer=None) -> (state, metrics)``.
    ``batch`` holds ``tokens`` and ``labels`` (b, s) on the LM's device,
    optionally ``loss_mask``.  ``timer(phase)``, if given, is called after
    the forward, the backward and the optimizer update ("forward",
    "backward", "optimizer"), for measurements."""
    opt_cfg = opt_cfg or AdamWConfig()
    opt_update = qadamw_update if optimizer == "adamw8bit" else adamw_update

    def mark(timer, phase):
        if timer is not None:
            timer(phase)

    def train_step(state, batch, *, timer=None):
        model = state["params"]
        params = dict(model.named_parameters())
        with torch.enable_grad():
            # remat is applied PER PERIOD inside the layer stack (models/lm.py)
            logits, aux = forward(cfg, model, batch, remat=remat)
            loss = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
            del logits
            metrics = {"ce_loss": loss.detach()}
            if "moe_balance" in aux:
                loss = loss + moe_aux_weight * aux["moe_balance"]
                metrics["moe_balance"] = aux["moe_balance"].detach()
            for key, value in aux.items():
                metrics.setdefault(key, value.detach())
            mark(timer, "forward")
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        # under a mesh each gradient takes its parameter's placements (a
        # sum over the data ranks, a slice of a replicated one)
        grads = {k: g.redistribute(params[k].device_mesh, params[k].placements)
                 if isinstance(g, DTensor) else g for k, g in grads.items()}
        mark(timer, "backward")
        grads, gn = clip_by_global_norm(grads, opt_cfg.clip_norm)
        _, opt, extra = opt_update(opt_cfg, params, grads, state["opt"])
        mark(timer, "optimizer")
        metrics = {**metrics, **extra, "loss": loss.detach(), "grad_norm": gn}
        # the metrics come back as plain (replicated) tensors
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in metrics.items()}
        return {"params": model, "opt": opt}, metrics

    return train_step


def make_prefill_step(cfg):
    """``prefill_step(params, batch)``: ``models.prefill``; ``batch`` carries
    the tokens and the frontend embeddings (``img_embeds``,
    ``audio_embeds``) through.  The decode step needs no frontend: the
    cross attention's keys and values live in the cache."""

    def prefill_step(params, batch):
        return prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg):
    def decode_fn(params, token, pos, cache):
        return model_decode(cfg, params, token, pos, cache)

    return decode_fn
