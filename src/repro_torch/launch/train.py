"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

Trains the SMOKE variant of an architecture (``--full``: the FULL config)
on the JAX package's synthetic Markov token stream with its train step:
f32 master weights from seed 0, AdamW under a warmup-cosine schedule
(warmup a tenth of ``--steps``), no remat, the ``chunked`` route. Runs on
``--device`` (default ``cuda``; ``cpu`` runs the same step on the CPU).
``--ckpt PATH`` saves the final ``TrainState`` in the JAX package's
checkpoint format. ``--dry-run`` needs launch/dryrun, which is not ported
yet, and raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Runs the loop; returns the final ``TrainState``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (a card required)")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower-only on the production mesh (not ported "
                    "yet: raises NotImplementedError)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the optimizer")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run needs launch/dryrun, which is not ported yet")

    import torch

    from repro_torch import configs
    from repro_torch.core.types import resolve_device
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import init_model
    from repro_torch.training import (make_train_step, save_checkpoint,
                                      train_state_init)

    device = resolve_device(args.device)
    cfg = configs.get_config(args.arch) if args.full else \
        configs.get_smoke(args.arch)
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} on {device}")
    state = train_state_init(init_model(cfg, seed=0, device=device))
    step_fn = make_train_step(
        cfg, peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, remat=False)
    ds = iter(SyntheticLMDataset(vocab_size=cfg.vocab_size,
                                 seq_len=args.seq, batch_size=args.batch))
    t0 = time.time()
    for i, batch in zip(range(args.steps), ds):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if cfg.frontend_tokens:
            batch["frontend"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.frontend_dim),
                device=device)
        if cfg.is_encdec:
            batch["encoder_frames"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.frontend_dim),
                device=device)
        state, m = step_fn(state, batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} ({time.time() - t0:.1f}s)",
                  flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, state, step=args.steps)
        print("saved", args.ckpt)
    return state


if __name__ == "__main__":
    main()
