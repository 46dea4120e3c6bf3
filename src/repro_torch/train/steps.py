"""Step functions (the JAX package's ``train/steps.py``): the training step
(forward, backward, global-norm clipping and AdamW) and the two serve steps
(prefill, decode).

The reference's steps are pure functions of (state, batch) that ``jax.jit``
compiles.  Here the state is ``{"params": LM, "opt": {"m", "v", "step"}}``
and the step updates it in place (the weights and moments are the card's
largest buffers) and returns it with the metrics, which stay on the device.
"""

from __future__ import annotations

import torch

from ..models import decode_step as model_decode
from ..models import forward, init_params, prefill
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..optim.adamw import AdamWConfig
from ..optim.quantized import qadamw_init, qadamw_update


def cross_entropy_loss(logits, labels, mask=None):
    """Stable cross entropy over the vocab axis in float32; with ``mask``
    the masked mean."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
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
        mark(timer, "backward")
        grads, gn = clip_by_global_norm(grads, opt_cfg.clip_norm)
        _, opt, extra = opt_update(opt_cfg, params, grads, state["opt"])
        mark(timer, "optimizer")
        metrics = {**metrics, **extra, "loss": loss.detach(), "grad_norm": gn}
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
