"""Batched serving launcher (the JAX package's ``launch/serve.py``): a
greedy prefill of a batch of prompts, then a per-token decode loop against
the padded KV caches, on one device or on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --reduced \\
        --batch 4 --prompt-len 16 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b --full \\
        --batch 4 --prompt-len 2048 --gen 32          # on the card, weights from --seed

Every config of ``configs/`` serves (``--arch <any>``).  The weights are
drawn on the device from ``--seed`` (``models.init_params``), the prompts
from a generator of the same seed; a config with image tokens gets
``frontends.fake_img_embeds`` in its first positions, an encoder-decoder
config ``frontends.fake_audio_embeds`` of ``--prompt-len`` frames, as the
reference's ``run`` builds them.  On the card each prefill runs the
attention of every attention layer (the encoder's and the cross attention
too) through the CUDA ``flash_attention_fwd`` kernel; the decode steps
attend with plain torch (``decode_attention``), as the reference does.
``--device cuda`` (the default) raises without a card.

The mesh: with ``--model-parallel N`` or a default process group (of any
size; a group of one is a mesh of one), the weights are placed by
``distributed.param_shardings(..., fsdp=False)`` over
``launch.mesh.make_local_mesh(model=N)``, prefill and decode run inside
``activation_sharding`` (the MoE's prefill on the expert-parallel path, the
attention kernel on each rank's heads), and the padded caches are placed by
``cache_shardings``, as the reference's ``run`` does.  Every rank runs the
same launcher and returns the same tokens.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import get_config
from ..distributed.constraints import activation_sharding
from ..distributed.sharding import (batch_spec, cache_shardings, param_shardings, place,
                                     place_module)
from ..launch.mesh import make_local_mesh
from ..models import init_params, pad_cache, prefill
from ..models.frontends import fake_audio_embeds, fake_img_embeds
from ..train.steps import make_decode_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, *, model=None, prompts=None, embeds=None, feed=None, record=None):
    """Serve one batch; returns ``{"prefill_s", "decode_s", "tokens"}``, the
    tokens (b, gen) as numpy (on a mesh also ``"mesh"`` and ``"cache"``).
    For tests and measurements: ``model`` serves an existing ``LM`` (at its
    own config, a depth cut included) instead of drawing one, ``prompts``
    (b, prompt_len) replaces the random prompts, ``embeds`` (``{"img_embeds"}`` or
    ``{"audio_embeds"}``, numpy or tensors) the drawn frontend embeddings,
    ``feed`` (b, gen) replaces the greedy token fed to decode step i by
    ``feed[:, i]`` (teacher forcing), and ``record(step, logits)`` sees the
    logits of the prefill (step 0) and of each decode step."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device is available; pass --device cpu")
    if model is None:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = init_params(cfg, args.seed, device)
    cfg = model.cfg
    mesh, sharding = None, contextlib.nullcontext()
    if args.model_parallel > 1 or dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1:
        mesh = make_local_mesh(model=args.model_parallel, device=device)
        sharding = activation_sharding(dp=("data",), tp="model", tp_size=mesh.size(1),
                                       mesh=mesh)
        if not any(isinstance(p, DTensor) for p in model.parameters()):
            place_module(model, mesh, param_shardings(mesh, model, fsdp=False))

    b, plen, gen = args.batch, args.prompt_len, args.gen
    if prompts is None:
        g = torch.Generator(device=device).manual_seed(args.seed)
        prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g, device=device)
    prompts = torch.as_tensor(prompts, device=device)
    batch = {"tokens": prompts}
    if cfg.n_img_tokens:
        batch["img_embeds"] = fake_img_embeds(cfg, b, device=device)
    if cfg.enc_dec:
        batch["audio_embeds"] = fake_audio_embeds(cfg, b, plen, device=device)
    for name, x in (embeds or {}).items():
        batch[name] = torch.as_tensor(x, device=device)
    if mesh is not None:  # the same full batch on every rank: each keeps its rows
        batch = {k: place(v, mesh, batch_spec(mesh, v)) for k, v in batch.items()}

    def whole(t):  # a replicated plain tensor of (DTensor) logits
        return t.full_tensor() if isinstance(t, DTensor) else t

    with sharding:
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, model, batch)
        cache = pad_cache(cfg, cache, plen + gen)
        if mesh is not None:
            csh = cache_shardings(mesh, cache)
            cache = {k: {n: place(t, mesh, csh[k][n]) for n, t in c.items()}
                     for k, c in cache.items()}
        logits = whole(logits)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        if record is not None:
            record(0, logits)

        decode = make_decode_step(cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            if feed is not None:
                tok = torch.as_tensor(feed, device=device)[:, i].to(torch.int32)
            pos = torch.full((b,), plen + i, dtype=torch.int32, device=device)
            logits, cache = decode(model, tok, pos, cache)
            logits = whole(logits)
            if record is not None:
                record(i + 1, logits)
            tok = torch.argmax(logits, -1).to(torch.int32)
            out_tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0

    gen_tokens = torch.stack(out_tokens, 1).cpu().numpy()
    print(f"[serve] prefill {plen} tokens x {b} seqs: {t_prefill*1e3:.1f} ms")
    print(f"[serve] decode {gen-1} steps: {t_decode*1e3:.1f} ms "
          f"({(gen-1)*b/max(t_decode,1e-9):.1f} tok/s)")
    print(f"[serve] sample continuation: {gen_tokens[0, :16].tolist()}")
    out = {"prefill_s": t_prefill, "decode_s": t_decode, "tokens": gen_tokens}
    if mesh is not None:  # and on a mesh, the mesh and the caches in their placements
        out.update(mesh=mesh, cache=cache)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()

