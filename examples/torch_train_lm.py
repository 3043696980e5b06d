#!/usr/bin/env python3
"""End-to-end training driver on the PyTorch port: train an
assigned-architecture LM on the CUDA card with the full substrate
(seeded init, WSD schedule, prefetching loader, atomic checkpoints +
restart).

The default trains the reduced qwen3-0.6b; ``--full-100m`` registers
and trains a ~100M-parameter qwen3-family config.  A rerun with the
same ``--ckpt-dir`` resumes from its latest checkpoint.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import register  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402


def register_100m():
    base = get_arch("qwen3-0.6b")
    cfg = base.replace(name="qwen3-100m", num_layers=12, d_model=768,
                       num_heads=12, num_kv_heads=4, head_dim=64,
                       d_ff=2048, vocab_size=32000)
    register(cfg, cfg)
    return cfg.name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "train_lm_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    a = ap.parse_args(argv)

    if a.full_100m:
        arch, reduced = register_100m(), False
    else:
        arch, reduced = "qwen3-0.6b", True

    out = run(arch, reduced=reduced, steps=a.steps, batch=a.batch, seq=a.seq,
              lr=3e-3, ckpt_dir=a.ckpt_dir, save_every=a.save_every,
              schedule="wsd", device=a.device)
    if out["steps"]:
        print(f"final loss {out['final_loss']:.4f} after {out['steps']} "
              f"steps from step {out['start_step']} ({out['seconds']:.0f}s); "
              f"checkpoints in {a.ckpt_dir}")
    print("loss curve (every 20):",
          [round(x, 3) for x in out["losses"][::20]])
    return {"arch": arch, "ckpt_dir": a.ckpt_dir, **out}


if __name__ == "__main__":
    main()
