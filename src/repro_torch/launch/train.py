"""Training launcher of the PyTorch/CUDA port (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --smoke --steps 50 --batch 4 --seq 64 --ckpt artifacts/ckpt/xlstm

Trains on ``--device cuda`` (the default; it fails when no card is
present) or ``--device cpu`` on the ``mixed`` synthetic corpus (markov and
copy sequences), with the multi-exit loss and AdamW (warmup a tenth of
``--steps``), from random weights initialised from ``--seed``.
``--smoke`` trains the reduced configuration (2 layers, d_model 256);
without it the full one, in float32 (ee-llm-7b's full width needs its
depth cut to fit one 80 GB card: ``chip_smoke.py`` phase 13).  whisper
and paligemma draw their frames or patches from a ``torch.Generator``.
``--ckpt`` writes the trained parameters in the JAX package's checkpoint
format (``<ckpt>.npz`` and ``<ckpt>.json``), which
``repro_torch.launch.serve --ckpt`` and the JAX package's
``load_checkpoint`` read.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.data.synthetic import DataConfig, SyntheticCorpus
from repro_torch.models.registry import build_model
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optim import AdamWConfig, init_adamw
from repro_torch.training.train_step import make_train_step


def add_modality(batch, cfg, gen: torch.Generator):
    """Add whisper's frames or paligemma's patches, N(0, 0.1²) from
    ``gen``, on the batch's device."""
    b, dev = batch["tokens"].shape[0], batch["tokens"].device
    if cfg.is_encdec:
        batch["frames"] = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=dev) * 0.1
    if cfg.vision_tokens:
        batch["patches"] = torch.randn((b, cfg.vision_tokens, cfg.d_model),
                                       generator=gen, device=dev) * 0.1
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ee-llm-7b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights, the corpus and the "
                         "frames or patches")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"exits={cfg.exit_layers}")
    model = build_model(cfg, device=args.device, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.1f}M")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    opt = init_adamw(model)
    step = make_train_step(model, opt_cfg)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq, batch_size=args.batch,
                                      kind="mixed", seed=args.seed))
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    t0 = time.time()
    for i, b in enumerate(data.batches(args.steps)):
        batch = add_modality({k: torch.from_numpy(v).to(model.device)
                              for k, v in b.items()}, cfg, gen)
        batch["tokens"] = batch["tokens"].long()
        opt, mets = step(opt, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            exits = {k: round(float(v), 3) for k, v in mets.items()
                     if k.startswith("exit")}
            print(f"step {i:4d} loss={float(mets['loss']):.4f} "
                  f"main={float(mets['main_loss']):.4f} {exits} "
                  f"lr={float(mets['lr']):.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, model, cfg,
                        extra={"arch": cfg.name, "steps": args.steps})
        print(f"saved checkpoint to {args.ckpt}.npz")
    return model, mets


if __name__ == "__main__":
    main()
