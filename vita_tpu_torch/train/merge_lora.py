"""LoRA merge tool on the PyTorch port: ``python -m vita_tpu_torch.train.merge_lora``
(vita_tpu.train.merge_lora).

Loads a base checkpoint and trained adapters, folds the adapters into the
base weights, and saves a native checkpoint that needs no LoRA code to
serve (the reference's script/merge_lora_weights.py:8-28). The adapters
are a directory in ``trainer.save_state``'s layout (the latest
``step_N/state.pt``); ``--device`` defaults to ``cuda``.

    python -m vita_tpu_torch.train.merge_lora --base ckpt --lora adapters \\
        --output merged --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Merge LoRA adapters into a base checkpoint")
    p.add_argument("--base", required=True, help="base VITA checkpoint dir")
    p.add_argument("--lora", required=True, help="directory holding the adapter dict")
    p.add_argument("--output", required=True)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from vita_tpu_torch.checkpoint import load_lora_vita_checkpoint, save_vita_checkpoint

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch; pass --device cpu to run on the CPU")
    cfg, merged = load_lora_vita_checkpoint(args.base, args.lora, rank=args.rank,
                                            alpha=args.alpha, device=device)
    save_vita_checkpoint(args.output, cfg, merged)
    print(f"[merge-lora] wrote merged checkpoint to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
