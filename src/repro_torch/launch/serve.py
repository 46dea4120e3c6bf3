"""Batched serving launcher on one device (the JAX package's
``launch/serve.py``): a greedy prefill of a batch of prompts, then a
per-token decode loop against the padded KV caches.

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
``--device cuda`` (the default) raises without a card;
``--model-parallel`` above 1 raises (``distributed/`` is not ported).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import init_params, pad_cache, prefill
from ..models.frontends import fake_audio_embeds, fake_img_embeds
from ..train.steps import make_decode_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, *, model=None, prompts=None, embeds=None, feed=None, record=None):
    """Serve one batch; returns ``{"prefill_s", "decode_s", "tokens"}``, the
    tokens (b, gen) as numpy.  For tests and measurements: ``model`` serves
    an existing ``LM`` (at its own config, a depth cut included) instead of
    drawing one, ``prompts`` (b, prompt_len)
    replaces the random prompts, ``embeds`` (``{"img_embeds"}`` or
    ``{"audio_embeds"}``, numpy or tensors) the drawn frontend embeddings,
    ``feed`` (b, gen) replaces the greedy token fed to decode step i by
    ``feed[:, i]`` (teacher forcing), and ``record(step, logits)`` sees the
    logits of the prefill (step 0) and of each decode step."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device is available; pass --device cpu")
    if args.model_parallel != 1:
        raise NotImplementedError("serve: one device only (ROADMAP A-17)")
    if model is None:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = init_params(cfg, args.seed, device)
    cfg = model.cfg

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

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, model, batch)
    cache = pad_cache(cfg, cache, plen + gen)
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
    return {"prefill_s": t_prefill, "decode_s": t_decode, "tokens": gen_tokens}


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

