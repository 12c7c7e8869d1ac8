"""End-to-end training launcher (port of ``repro/launch/train.py``).

Real steps on one device: synthetic Markov token data
(``data/tokens.py``), the full train step (CE + AdamW + optional
microbatches), periodic async checkpoints, and checkpoint/restart:
``--resume`` picks up the latest committed step. The run is on the card
unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --reduced --steps 50 --ckpt /tmp/ckpt --device cpu

A resumed run skips the stream's batches that its checkpoint has seen, so
``--steps N`` resumed from step k takes the batches k + 1 .. N of an
unbroken run and ends where it ends, bit for bit. (The reference's
resumed run starts the stream again from its first batch.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.tokens import MarkovTokens, TokenDataConfig
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.optimizer import AdamWConfig, warmup_cosine
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.device import resolve

ENCDEC_REFUSED = ("use --arch with a decoder-only config for the token-LM "
                  "training driver")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def vlm_extras(cfg, batch: dict, device) -> dict:
    """The vlm family's stub inputs, as the reference's launcher makes
    them: zero patch embeddings over the first n_patches positions and
    text M-RoPE positions (t = h = w)."""
    b, s = batch["tokens"].shape
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return {"patch_embeds": torch.zeros((b, min(cfg.n_patches, s),
                                         cfg.d_model), device=device),
            "positions": pos[..., None].expand(b, s, 3).contiguous()}


def run(args) -> list[dict]:
    """The training loop of ``args`` (``parse_args``); returns each step's
    metrics as floats, with its ``step``."""
    device = resolve(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatches=1)
    if cfg.family == "encdec":
        raise SystemExit(ENCDEC_REFUSED)
    opt_cfg = AdamWConfig(
        lr=warmup_cosine(args.lr, warmup=20, total=args.steps),
        weight_decay=0.01)
    params, opt_state = init_train_state(args.seed, cfg, opt_cfg, device)

    start_step = 0
    if args.resume and args.ckpt:
        latest = ckpt_mod.latest_step(args.ckpt)
        if latest is not None:
            state = ckpt_mod.restore(args.ckpt, latest,
                                     {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}")

    step_fn = make_train_step(cfg, opt_cfg)
    data = MarkovTokens(TokenDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed))
    saver = ckpt_mod.AsyncCheckpointer()
    out = []
    t0 = time.time()
    for step, host in enumerate(data.batches(args.steps), start=1):
        if step <= start_step:
            continue
        batch = {k: torch.as_tensor(np.asarray(v), device=device)
                 for k, v in host.items()}
        if cfg.family == "vlm":
            batch.update(vlm_extras(cfg, batch, device))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        out.append({"step": step, **m})
        if step % 10 == 0 or step == start_step + 1:
            print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                  f"lr {m['lr']:.2e} ({(time.time() - t0):.1f}s)")
        if args.ckpt and step % args.ckpt_every == 0:
            saver.save(args.ckpt, step, {"params": params, "opt": opt_state})
    saver.wait()
    print(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s")
    return out


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
