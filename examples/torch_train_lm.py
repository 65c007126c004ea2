"""End-to-end training example of the PyTorch port (counterpart of
``examples/train_lm.py``): train a ~100M-parameter llama-style model for a
few hundred steps on the card, with checkpointing and restart.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--params 100]
        [--device cuda]

The model is a width-scaled smollm-family config sized to ~``--params``
million parameters (f32, depth fixed at 12); data comes from the synthetic
token pipeline through the host prefetcher.  The loop is the port's
fault-tolerant one (``repro_torch.train.loop``): resume from checkpoint,
periodic atomic saves, straggler accounting.  ``--ckpt`` defaults to a
directory under the system's temporary directory.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.data.pipelines import Prefetcher, lm_batches
from repro_torch.models.transformer import LMConfig, forward_train, init_params
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamWConfig


def config_for_params(target_m: float) -> LMConfig:
    """Scale width to hit roughly target_m million params (depth fixed)."""
    vocab, layers = 32000, 12
    d = 256
    while True:
        cfg = LMConfig(
            name=f"lm-{target_m}m", n_layers=layers, d_model=d,
            n_heads=max(4, d // 64), n_kv_heads=max(2, d // 128),
            d_ff=int(d * 8 / 3) // 64 * 64, vocab=vocab, tie_embeddings=True,
            param_dtype=torch.float32, act_dtype=torch.float32,
        )
        if cfg.param_count() >= target_m * 1e6 or d > 4096:
            return cfg
        d += 64


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--params", type=float, default=100, help="millions")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = config_for_params(args.params)
    print(f"model: {cfg.name}  d_model={cfg.d_model}  params={cfg.param_count()/1e6:.0f}M")

    batches = Prefetcher(lm_batches(cfg.vocab, args.batch, args.seq))

    def loss_fn(params, batch):
        return forward_train(cfg, params, batch["tokens"], batch["labels"])

    res = train(
        loss_fn,
        lambda: init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        lambda step: next(batches),
        n_steps=args.steps,
        ckpt_dir=args.ckpt,
        ckpt_every=50,
        opt_cfg=AdamWConfig(lr=3e-4),
        device=dev,
    )
    w = 20
    print(f"loss: first{w}={np.mean(res.losses[:w]):.3f} "
          f"last{w}={np.mean(res.losses[-w:]):.3f} "
          f"(restarts={res.restarts}, stragglers={res.straggler_steps})")
    batches.close()


if __name__ == "__main__":
    main()
