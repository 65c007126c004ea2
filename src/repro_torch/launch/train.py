"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--steps 100] [--batch 8] [--seq 128] [--ckpt DIR] [--ckpt-every 25] \
        [--lr 3e-4] [--compress-grads] [--device cuda]

Trains the architecture's ``reduced_config()`` on synthetic batches (an
LM on ``lm_batches``; NequIP on one ``random_graph`` of 64 nodes, 256
edges and 4 graphs, every step, its loss over the 4 graphs' energies; a
recsys model on ``recsys_batches``, in sequence mode for ``sasrec``)
through the fault-tolerant loop
(``repro_torch.train.loop``): resume from the latest checkpoint under
``--ckpt``, periodic atomic saves, straggler accounting, optional int8
error-feedback gradient compression.  The flags and the output line are
the reference's, plus ``--device`` (the card unless ``cpu`` is asked for);
``--ckpt`` defaults to a directory under the system's temporary directory.
``--batch`` applies to LMs and recsys models, ``--seq`` to LMs only.
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.registry import ALL_ARCHS, RECSYS, get_arch_module
from repro_torch.data.pipelines import lm_batches, random_graph, recsys_batches
from repro_torch.models import nequip
from repro_torch.models.transformer import forward_train, init_params
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ALL_ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the parameters and batches (cuda or cpu)")
    args = ap.parse_args(argv)

    mod = get_arch_module(args.arch)
    cfg = mod.reduced_config()
    dev = resolve_device(args.device)
    if mod.FAMILY == "lm":
        it = lm_batches(cfg.vocab, args.batch, args.seq)
        init = init_params

        def loss(cfg, params, batch):
            return forward_train(cfg, params, batch["tokens"], batch["labels"])

    elif mod.FAMILY == "gnn":
        it = itertools.repeat(random_graph(64, 256, cfg.d_feat_in, n_graphs=4))
        init = nequip.init_params

        def loss(cfg, params, batch):
            return nequip.forward_train(cfg, params, batch, 4)

    else:
        init, loss = RECSYS[args.arch]
        if args.arch == "sasrec":
            it = recsys_batches((), args.batch, seq_len=cfg.seq_len, n_items=cfg.n_items)
        else:
            it = recsys_batches(cfg.vocab_sizes, args.batch,
                                n_dense=getattr(cfg, "n_dense", 0))

    def batch_fn(step):
        return next(it)

    def loss_fn(params, batch):
        return loss(cfg, params, batch)

    def init_fn():
        return init(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    res = train(
        loss_fn, init_fn, batch_fn,
        n_steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        opt_cfg=AdamWConfig(lr=args.lr),
        compress_grads=args.compress_grads, device=dev,
    )
    w = min(10, len(res.losses) // 2) or 1
    print(
        f"[{args.arch}] steps={res.final_step} "
        f"loss {np.mean(res.losses[:w]):.4f} -> {np.mean(res.losses[-w:]):.4f} "
        f"restarts={res.restarts} stragglers={res.straggler_steps}"
    )


if __name__ == "__main__":
    main()
