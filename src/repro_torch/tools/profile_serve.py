"""Where the LM serving path's time goes on the card (``models.LM``, as
``launch/serve`` drives it).

    PYTHONPATH=src python -m repro_torch.tools.profile_serve [--arch qwen2.5-14b]
        [--reduced] [--layers N] [--batch 4] [--prompt-len 2048] [--decode-steps 16]
        [--seed 0]

Draws the model's weights on the card from ``--seed`` (full width unless
``--reduced``; the first ``--layers`` layers only, for a model that does not
fit the card whole), with the frontend embeddings ``launch/serve`` gives a
config with image tokens or an encoder, and prints two JSON lines:

- ``prefill``: ``prefill_ms`` (host clock around one synchronized prefill of
  ``batch x prompt_len`` tokens) and, from ``torch.profiler`` over one
  prefill, the device operations, the device busy time and idle share, the
  busy time of the ``flash_attention_fwd`` kernel and the top device
  operations by time;
- ``decode``: ``ms_per_token`` (``decode_steps`` greedy steps issued back to
  back against the padded caches, then one synchronize, as the serve loop
  runs them) and the same profile per step.

``null`` profiles mean the profiler reported no device activity.  It needs a
CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..configs import get_config
from ..kernels import ops
from ..models import LM
from ..models.frontends import fake_audio_embeds, fake_img_embeds
from .profile_step import _profile, _sync_ms


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="qwen2.5-14b")
    parser.add_argument("--reduced", action="store_true")
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--prompt-len", type=int, default=2048)
    parser.add_argument("--decode-steps", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_config(opts.arch, reduced=opts.reduced)
    if opts.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=opts.layers)
    lm = LM(cfg, device=dev, seed=opts.seed)
    b, plen, steps = opts.batch, opts.prompt_len, opts.decode_steps
    g = torch.Generator(device=dev).manual_seed(opts.seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, plen), generator=g, device=dev)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = fake_img_embeds(cfg, b, device=dev)
    if cfg.enc_dec:
        batch["audio_embeds"] = fake_audio_embeds(cfg, b, plen, device=dev)
    head = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers, b=b, prompt_len=plen,
                device=torch.cuda.get_device_name(0))

    lm.prefill(batch)  # warm-up
    prefill_ms, _ = _sync_ms(lambda: lm.prefill(batch))
    before = ops.launches["flash_attention_fwd"]
    prof = _profile(lambda: lm.prefill(batch), 1)
    flash = ops.launches["flash_attention_fwd"] - before
    print(json.dumps({"phase": "prefill", **head, "prefill_ms": prefill_ms,
                      "prefill_tokens_per_s": b * plen / prefill_ms * 1e3,
                      "flash_launches": flash, "profile": prof}), flush=True)

    logits, cache = lm.prefill(batch)
    cache = lm.pad_cache(cache, plen + steps)
    first = torch.argmax(logits, -1).to(torch.int32)
    positions = [torch.full((b,), plen + i, dtype=torch.int32, device=dev) for i in range(steps)]

    def run():
        tok = first
        for pos in positions:
            lg, _ = lm.decode_step(tok, pos, cache)  # the caches are written in place
            tok = torch.argmax(lg, -1).to(torch.int32)
        return tok

    run()  # warm-up
    decode_ms, _ = _sync_ms(run)
    prof = _profile(run, steps)
    print(json.dumps({"phase": "decode", **head, "steps": steps,
                      "ms_per_token": decode_ms / steps,
                      "tokens_per_s": b * steps / decode_ms * 1e3, "profile": prof}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
