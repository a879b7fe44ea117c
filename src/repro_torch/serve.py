"""Batched serving: prefill + greedy decode with the ring-buffer KV cache;
twin of ``examples/serve_decode.py``.

    python -m repro_torch.serve --arch smollm-135m --requests 4 \\
        --prompt-len 32 --new-tokens 16 [--window W] [--full] [--device cpu]

The prompt is replayed through ``decode_step`` (cache warm-up), then the
requests decode greedily through ``make_serve_step``.  Every zoo config
serves; the replay carries tokens only, as the JAX package's example does
(no vision prefix, and the enc-dec's default memory of zeros).  The reduced
config runs unless ``--full`` is given; the card is used unless
``--device cpu``.  Weights are random, from seed 0; prompts from seed 1.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.configs.base import get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import make_serve_step


class Served(NamedTuple):
    tokens: torch.Tensor     # (requests, new_tokens) generated token ids
    prefill_s: float         # wall seconds of the prompt replay
    decode_s: float          # wall seconds of the new_tokens - 1 serve steps


def generate(model, prompts: torch.Tensor, new_tokens: int) -> Served:
    """Replay ``prompts`` (B, L) through ``decode_step``, then decode
    ``new_tokens`` greedily (the first from the replay's last logits)."""
    sync = (torch.cuda.synchronize if prompts.device.type == "cuda"
            else (lambda: None))
    serve = make_serve_step(model)
    B, L = prompts.shape
    with torch.no_grad():
        cache = model.init_cache(B, prefill_len=0)
        sync()
        t0 = time.perf_counter()
        for t in range(L):
            logits, cache = model.decode_step(prompts[:, t:t + 1], cache,
                                              position=t)
        sync()
        prefill_s = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1:], -1)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            logits, cache = serve(tok, cache)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
    return Served(torch.cat(out, dim=1), prefill_s, decode_s)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=list_configs())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window KV size (sub-quadratic decode)")
    ap.add_argument("--full", action="store_true",
                    help="full config instead of the reduced variant")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = build_model(cfg, decode_window=args.window, device=dev)
    B = args.requests
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=gen, device=dev)
    res = generate(model, prompts, args.new_tokens)
    print(f"prefill {args.prompt_len} tokens x {B} requests: "
          f"{res.prefill_s:.2f}s")
    print(f"decoded {args.new_tokens} tokens x {B} requests in "
          f"{res.decode_s:.2f}s "
          f"({B * args.new_tokens / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample token ids:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
