"""Training driver with checkpoint/restart (the JAX package's
``repro/launch/train.py``), on the GPU unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced

AdamW with a cosine schedule and clipping, microbatching, asynchronous
checkpoints every --ckpt-every steps, resume from the latest complete
checkpoint, an injected failure at --fail-at that stops the loop
mid-run (run again to resume), and straggler detection hooks.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..configs import get_config, reduced_config
from ..models.model import Model, n_params
from ..train import checkpoint
from ..train.data import DataLoader
from ..train.fault_tolerance import StragglerDetector
from ..train.optimizer import AdamWConfig
from ..train.train_step import init_train_state, make_train_step, train_state_template


def train_loop(
    arch: str,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    reduced: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    microbatches: int = 1,
    fail_at: Optional[int] = None,
    seed: int = 0,
    log_every: int = 10,
    lr: float = 3e-4,
    device: str = "cuda",
) -> dict:
    """Train ``arch`` for ``steps`` steps; returns {"first_loss" (of this
    run), "last_loss", "final_step"}.  Raises RuntimeError after step
    ``fail_at`` (its checkpoint, if due, written first)."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    model = Model(cfg, device=device)
    dev = model.device
    opt_cfg = AdamWConfig(lr_peak=lr, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, num_microbatches=microbatches)
    loader = DataLoader(cfg, batch, seq, seed=seed)

    start_step = 0
    state = None
    writer = None
    if ckpt_dir:
        writer = checkpoint.AsyncWriter(ckpt_dir, keep=2)
        last = checkpoint.latest_step(ckpt_dir)
        if last is not None:
            state, meta = checkpoint.restore(ckpt_dir, train_state_template(model), device=dev)
            start_step = meta["step"]
            loader.restore(meta["loader"])
            print(f"[resume] restored step {start_step} from {ckpt_dir}")
    if state is None:
        state = init_train_state(model, torch.Generator(device=dev).manual_seed(seed))
    print(
        f"[train] {cfg.name} ({'reduced' if reduced else 'full'}) on {dev} "
        f"params={n_params(state.params):,} steps={steps}"
    )

    stragglers = StragglerDetector()
    losses = []
    for step in range(start_step, steps):
        batch_t = {k: torch.from_numpy(v).to(dev) for k, v in loader.next().items()}
        t0 = time.time()
        state, metrics = step_fn(state, batch_t)
        loss = float(metrics["loss"])  # reads the loss back: the step has run
        dt = time.time() - t0
        stragglers.record(host=0, step_time=dt)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(
                f"  step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt*1e3:.0f} ms)"
            )
        if writer and (step + 1) % ckpt_every == 0:
            writer.submit(step + 1, state, {"loader": loader.state()})
        if fail_at is not None and step + 1 == fail_at:
            if writer:
                writer.close()
            raise RuntimeError(f"injected failure at step {fail_at}")
    if writer:
        writer.submit(steps, state, {"loader": loader.state()})
        writer.close()
    return {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "final_step": steps,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description="Train a registered arch with the port.")
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    res = train_loop(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
        reduced=args.reduced, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, microbatches=args.microbatches,
        fail_at=args.fail_at, seed=args.seed, device=args.device,
    )
    print(f"[done] {res}")


if __name__ == "__main__":
    main()
