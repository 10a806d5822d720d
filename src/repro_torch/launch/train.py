"""LM training launcher of the port: real steps on synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b --steps 20 \
        --batch 2 --seq 64 --layers 2 --d-model 128 --vocab 512 --device cpu

The counterpart of the JAX package's ``launch/train.py``: a reduced
config (:func:`reduced_lm`) unless ``--full-config``, the train cell of
``launch/steps.py`` at the reference launcher's lr 3e-3, batches from
``TokenStream`` through the ``Prefetcher``, and checkpoint / resume
through ``CheckpointManager`` with ``{"stream_step": step + 1}`` as the
metadata, so a resumed run reads the batches an uninterrupted one would
have read.  The checkpoint holds the train state in the JAX package's
layout and keys: either package resumes the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..checkpoint import CheckpointManager
from ..configs.base import LMArch, LMShape
from ..configs.registry import ArchBundle, get_arch
from ..data.pipeline import Prefetcher
from ..data.tokens import TokenStream
from .steps import build_lm_cell

__all__ = ["reduced_lm", "train_lm", "main"]

LR = 3e-3  # the reference launcher's


def reduced_lm(arch: LMArch, layers: int, d_model: int, vocab: int) -> LMArch:
    """Shrink an LM config for CPU-scale runs, preserving its character
    (GQA ratio, MoE-ness, activation): the JAX package's ``reduced_lm``."""
    head_dim = 64
    n_heads = max(2, d_model // 128)
    n_kv = max(1, min(arch.n_kv_heads, n_heads))
    moe = None
    if arch.moe is not None:
        moe = dataclasses.replace(
            arch.moe, num_experts=min(arch.moe.num_experts, 8), d_ff=d_model * 2
        )
    return dataclasses.replace(
        arch,
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_model * 4,
        vocab=vocab,
        moe=moe,
        q_chunk=128,
        loss_chunk=128,
    )


def train_lm(
    cfg: LMArch,
    steps: int,
    batch: int,
    seq: int,
    ckpt_dir: str | None = None,
    save_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    device=None,
) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` sequences of ``seq``
    tokens on ``device`` (None: the card), resuming from ``ckpt_dir``'s
    latest checkpoint when it holds one.  Returns ``{"losses", "final_loss",
    "state"}``: the losses of the steps this call ran and the final train
    state in the JAX package's layout (the live tensors)."""
    shape = LMShape("train", "train", seq, batch)
    cell = build_lm_cell(ArchBundle(cfg, {"train": shape}), "train", device=device, seed=seed,
                         lr=LR)
    stream = TokenStream(vocab=cfg.vocab, batch=batch, seq_len=seq, seed=seed)
    manager = (
        CheckpointManager(ckpt_dir, save_every=save_every, async_writes=True)
        if ckpt_dir
        else None
    )
    start_step = 0
    if manager is not None:
        state, _, start_step = manager.restore_or_init(cell.train_state())
        if start_step:
            cell.load_train_state(state)
            print(f"resumed from step {start_step}")

    prefetch = Prefetcher(stream.batch_at, depth=2, start_step=start_step)
    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            _, tokens = prefetch.get()
            losses.append(float(cell.fn({"tokens": tokens})["loss"]))
            if step % log_every == 0 or step == steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:8.4f} ({dt:6.1f}s)")
            if manager is not None:
                manager.maybe_save(step, cell.train_state(), {"stream_step": step + 1})
    finally:
        prefetch.close()
        if manager is not None:
            manager.ckpt.close()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "state": cell.train_state()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true", help="no reduction")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path on the host)")
    args = ap.parse_args(argv)

    bundle = get_arch(args.arch)
    if not isinstance(bundle.arch, LMArch):
        raise SystemExit("train.py drives LM archs; DLRM trains through launch/steps.py's cell")
    cfg = (
        bundle.arch
        if args.full_config
        else reduced_lm(bundle.arch, args.layers, args.d_model, args.vocab)
    )
    out = train_lm(cfg, args.steps, args.batch, args.seq, args.ckpt_dir, device=args.device)
    print("final loss:", out["final_loss"])


if __name__ == "__main__":
    main()
