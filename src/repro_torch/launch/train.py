"""Training launcher: ``python -m repro_torch.launch.train --arch <id> …``.

Port of ``repro.launch.train`` on one device: the same flags, plus
``--device`` (``cuda`` unless ``--device cpu`` is given). ``--dp-compress``
(int8 gradient all-reduce across a mesh) is refused, as the port has no
mesh yet.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--dp-compress", action="store_true",
                    help="int8 gradient all-reduce with error feedback "
                         "(not ported: refused)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    model = (configs.smoke_config(args.arch) if args.smoke
             else configs.get_config(args.arch))
    tc = TrainConfig(
        model=model,
        opt=OptConfig(lr=args.lr, total_steps=args.steps),
        global_batch=args.global_batch, seq_len=args.seq,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        dp_compress=args.dp_compress)
    trainer = Trainer(tc, device=args.device)
    trainer.install_preemption_handler()
    if args.resume and trainer.restore_if_any():
        print(f"resumed from step {trainer.step}")
    for h in trainer.run(args.steps, log_every=10):
        print(f"step {h['step']:6d} loss {h['loss']:.4f} {h['sec']:.2f}s")


if __name__ == "__main__":
    main()
