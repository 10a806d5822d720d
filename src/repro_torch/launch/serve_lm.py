"""LM serving launcher of the port: batched decoding with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch gemma-7b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Runs prefill, then a greedy decode loop: the serving path of the JAX
package's ``launch/serve_lm.py``.  ``--reduced`` shrinks the model
(``reduced_lm(layers=2, d_model=256, vocab=2048)``); ``--device``
defaults to the CUDA card and the run fails without one unless
``--device cpu`` is given.  The cache is allocated once at prompt + gen
positions and filled in place.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import LMArch
from ..configs.registry import get_arch
from ..device import resolve_device
from ..interop import lm_params_from_jax
from ..models.transformer import TransformerLM
from .train import reduced_lm

__all__ = ["serve_loop", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_loop(cfg: LMArch, batch: int, prompt_len: int, gen: int, seed: int = 0, *,
               device=None, params=None, prompts=None) -> tuple[np.ndarray, float, float]:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then greedily
    decode: -> (tokens i32 [batch, gen], prefill s, decode s).  The model
    is ``params`` (a :class:`TransformerLM` on the device, or the JAX
    package's parameter tree as numpy arrays), else drawn on the device
    from ``seed``; the prompts are ``prompts`` (i32 [batch, prompt_len]),
    else drawn uniformly from the vocab on the device from ``seed + 1``."""
    dev = resolve_device(device)
    if params is None:
        model = TransformerLM(cfg, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(seed))
    elif isinstance(params, TransformerLM):
        if params.cfg != cfg or params.device.type != dev.type:
            raise ValueError(f"the model was built for {params.cfg.name} on {params.device}, "
                             f"not {cfg.name} on {dev}")
        model = params
    else:
        model = TransformerLM(cfg, device=dev)
        model.load_state_dict(lm_params_from_jax(cfg, params))
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), dtype=torch.int32, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(seed + 1))
    else:
        prompts = (prompts.to(dev) if isinstance(prompts, torch.Tensor)
                   else torch.tensor(np.asarray(prompts), device=dev)).to(torch.int32)
        if tuple(prompts.shape) != (batch, prompt_len):
            raise ValueError(f"prompts must be [{batch}, {prompt_len}], got {tuple(prompts.shape)}")
    max_seq = prompt_len + gen

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, max_seq=max_seq)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits, dim=-1)
    generated = [tokens]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, tokens, prompt_len + i)
        tokens = torch.argmax(logits, dim=-1)
        generated.append(tokens)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = torch.stack(generated, dim=1).to(torch.int32).cpu().numpy()
    return out, t_prefill, t_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' (plain PyTorch on the host)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).arch
    if not isinstance(cfg, LMArch):
        raise SystemExit(f"{args.arch} is not an LM arch")
    if args.reduced:
        cfg = reduced_lm(cfg, layers=2, d_model=256, vocab=2048)
    out, t_p, t_d = serve_loop(cfg, args.batch, args.prompt_len, args.gen, device=args.device)
    tok_s = args.batch * (args.gen - 1) / max(t_d, 1e-9)
    print(f"prefill {t_p:.2f}s; decode {t_d:.2f}s ({tok_s:.1f} tok/s)")
    print("sample generations (token ids):")
    for row in out[:2]:
        print("  ", row.tolist())


if __name__ == "__main__":
    main()
