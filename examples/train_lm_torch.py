"""End-to-end driver of the PyTorch port: train a reduced LM for a few
hundred steps (the counterpart of examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py                      # ~100M, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu  # CI-sized, on the host

Uses the port's substrate: the config system, the train cell (lm_loss
with remat, the optimizer), the synthetic token stream with prefetch,
and, with --ckpt-dir, async checkpointing with exact resume (rerun with
the same directory to continue; without it nothing is saved or resumed;
the checkpoint is in the JAX package's format, so either package's
launcher resumes it).
"""
import argparse

from repro_torch.configs import get_arch
from repro_torch.launch.train import reduced_lm, train_lm
from repro_torch.models.transformer import n_params


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here and resume from here (default: no checkpoints)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    base = get_arch("codeqwen1.5-7b").arch
    if args.tiny:
        cfg = reduced_lm(base, layers=2, d_model=128, vocab=1024)
        steps, batch, seq = args.steps or 30, 4, 128
    else:
        # ~100M params: 12 layers x d=768 (GPT-2-small-class)
        cfg = reduced_lm(base, layers=12, d_model=768, vocab=32768)
        steps, batch, seq = args.steps or 200, 4, 256

    print(f"training a {n_params(cfg) / 1e6:.0f}M-param LM for {steps} steps")
    out = train_lm(cfg, steps=steps, batch=batch, seq=seq, ckpt_dir=args.ckpt_dir,
                   device=args.device)
    first = sum(out["losses"][:10]) / max(len(out["losses"][:10]), 1)
    print(f"loss: {first:.3f} (first 10 avg) -> {out['final_loss']:.3f} (final)")


if __name__ == "__main__":
    main()
