"""Continuous-batching actor serving — the port's counterpart of
``examples/serve_actor.py`` (DESIGN.md §13): submit N random prompts, run
the slot scheduler to completion, report prefill and decode phases
separately with EXACT token accounting (``admissions + decoded_tokens ==
requests × gen`` is asserted before anything is printed or emitted).

    PYTHONPATH=src python -m repro_torch.serve_actor --arch granite_8b \\
        --attn-impl flash --buckets 128,256,512 --prompt-len 512 --gen 32 \\
        --slots 8 --requests 16 --max-len 544
    PYTHONPATH=src python -m repro_torch.serve_actor --arch granite_8b --smoke \\
        --device cpu --requests 6 --slots 3 --prompt-len 6 --gen 5

Weights are random, made on the device from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import backbone
from repro_torch.serve import SUPPORTED_FAMILIES, ActorServeConfig, ActorServer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of prompts to serve")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching decode slots")
    ap.add_argument("--prompt-len", type=int, default=12,
                    help="max prompt length (lengths sampled 1..this)")
    ap.add_argument("--gen", type=int, default=16,
                    help="generated tokens per request")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated prompt padding buckets "
                         "(default: prompt-len and its half)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="KV cache length (default: prompt-len + gen)")
    ap.add_argument("--attn-impl", choices=("naive", "flash", "chunked_q"),
                    default=None,
                    help="ModelConfig.attn_impl (default: the config's own); "
                         "flash runs on prefill lengths that are multiples of 128")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--emit-json", default=None, metavar="FILE",
                    help="write the phase-separated serving report")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family not in SUPPORTED_FAMILIES:
        print(f"{cfg.name}: family {cfg.family!r} is not servable — the "
              f"continuous-batching engine needs a position-indexed KV "
              f"cache (supported: {', '.join(SUPPORTED_FAMILIES)})",
              file=sys.stderr)
        return 2
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    device = resolve_device(args.device)

    max_len = args.max_len or (args.prompt_len + args.gen)
    if args.buckets:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    else:
        buckets = tuple(sorted({max(1, args.prompt_len // 2), args.prompt_len}))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = backbone.init_params(cfg, gen)
    server = ActorServer(cfg, params, ActorServeConfig(
        slots=args.slots, max_len=max_len, buckets=buckets,
        max_new_tokens=args.gen), device=device)

    rng = np.random.RandomState(args.seed)
    lens = rng.randint(1, args.prompt_len + 1, size=args.requests)
    handles = [server.submit(rng.randint(0, cfg.vocab_size, size=int(n)))
               for n in lens]
    server.drain(timeout=600)
    completions = [h.result(0) for h in handles]

    s = server.stats()
    # exact accounting: every generated token belongs to exactly one phase
    generated = sum(len(c.tokens) for c in completions)
    assert generated == args.requests * args.gen, (generated, args.requests,
                                                   args.gen)
    assert s["generated_tokens"] == generated, (s["generated_tokens"],
                                                generated)
    prefill_tokens = s["admissions"]          # one first-token per prefill
    decode_tokens = s["decoded_tokens"]
    prefill_s, decode_s = s["prefill_s"], s["decode_s"]

    print(f"{cfg.name} on {device} (attn_impl={cfg.attn_impl}): served "
          f"{args.requests} requests × {args.gen} tokens on {args.slots} slots "
          f"(buckets {buckets}, {s['prime_compiles']} prefill shapes, "
          f"{s['decode_compiles']} decode shape)")
    print(f"prefill: {prefill_tokens} prompts "
          f"({int(np.sum(lens))} prompt tokens) in {prefill_s*1e3:.1f} ms "
          f"— {prefill_tokens/prefill_s:.1f} first-tokens/s"
          if prefill_s > 0 else "prefill: instantaneous")
    print(f"decode:  {s['steps']} steps, {decode_tokens} tokens in "
          f"{decode_s*1e3:.1f} ms — {decode_tokens/decode_s:.1f} tok/s"
          if decode_s > 0 else "decode: no steps")
    if "latency_p50_ms" in s:
        print(f"latency: p50 {s['latency_p50_ms']:.1f} ms, "
              f"p99 {s['latency_p99_ms']:.1f} ms")
    print("sample tokens:", completions[0].tokens[:16])

    if args.emit_json:
        report = {
            "arch": cfg.name,
            "device": str(device),
            "attn_impl": cfg.attn_impl,
            "requests": args.requests,
            "slots": args.slots,
            "gen": args.gen,
            "buckets": list(buckets),
            "prefill": {
                "prompts": int(prefill_tokens),
                "prompt_tokens": int(np.sum(lens)),
                "first_tokens": int(prefill_tokens),
                "seconds": prefill_s,
            },
            "decode": {
                "steps": int(s["steps"]),
                "tokens": int(decode_tokens),
                "seconds": decode_s,
                "tokens_per_s": (decode_tokens / decode_s if decode_s > 0 else None),
            },
            "generated_tokens": int(generated),
            "latency_p50_ms": s.get("latency_p50_ms"),
            "latency_p99_ms": s.get("latency_p99_ms"),
            "prime_compiles": int(s["prime_compiles"]),
        }
        with open(args.emit_json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"# wrote {args.emit_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
