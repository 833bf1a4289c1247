"""Training entry point on the PyTorch port: ``python -m vita_tpu_torch.train.cli``
(vita_tpu.train.cli).

Example (smoke run, random tiny model, byte tokenizer):
  python -m vita_tpu_torch.train.cli --model tiny-random --stage finetune \\
      --data chat.json --output-dir /tmp/run --batch-size 2 --epochs 1

The flags are those of ``python -m vita_tpu.train.cli`` plus ``--device``
(default ``cuda``; without a card the command stops rather than train on
the CPU). ``--model tiny-random`` trains ``VITAConfig.tiny()`` from weights
drawn from a seeded generator, with the port's byte tokenizer; ``--model
<dir>`` loads a checkpoint directory and its tokenizer
(``checkpoint.load_vita_checkpoint``, ``cli.load_hf_tokenizer``).
``--pretrain-mm-adapter`` overlays a ``Trainer.save_trainable_only``
output of this port, ``--whale-init`` merges a standalone audio-encoder
``final.pt`` (``checkpoint.load_whale_torch_checkpoint``), and
``--lora-from`` folds in LoRA adapters saved by this port
(``trainer.save_state``'s layout). ``--moe-mode`` and ``--moe-chunk`` each
set only their own field. ``--mesh`` is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="VITA trainer on the PyTorch port")
    p.add_argument("--model", required=True, help="checkpoint dir or 'tiny-random'")
    p.add_argument("--data", required=True, nargs="+", help="conversation JSON path(s)")
    p.add_argument("--data-ratio", type=float, default=1.0)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--stage", choices=["pretrain_mlp", "finetune", "finetune_task"],
                   default="finetune")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--projector-lr", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--model-max-length", type=int, default=8192)
    p.add_argument("--max-patches", type=int, default=12)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--mesh", type=int, nargs="+", default=None,
                   help="mesh shape (not ported)")
    p.add_argument("--pipe-microbatches", type=int, default=4,
                   help="GPipe microbatches when the mesh has pipe > 1 (not ported)")
    p.add_argument("--moe-mode", default=None, choices=["dense", "capacity", "sort", "gmm"],
                   help="training MoE dispatch: dense (exact, E/k extra FLOPs), "
                        "capacity/sort (token-dropping), gmm (grouped matmul: exact "
                        "with top-k-only FLOPs)")
    p.add_argument("--moe-chunk", type=int, default=0,
                   help="run each layer's MoE over token chunks of this size, each "
                        "rematerialized in the backward (chunk-local aux loss)")
    p.add_argument("--pretrain-mm-adapter", default=None,
                   help="adapter-only checkpoint of a previous stage "
                        "(Trainer.save_trainable_only output) to overlay")
    p.add_argument("--whale-init", default=None,
                   help="standalone audio-encoder final.pt (torch) to shape-check-merge "
                        "into the audio tower")
    p.add_argument("--lora-from", default=None,
                   help="LoRA adapter checkpoint dir (this port's save_state layout) to "
                        "merge into the base before training")
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from vita_tpu_torch import checkpoint
    from vita_tpu_torch.cli import ByteTokenizer, load_hf_tokenizer
    from vita_tpu_torch.data.dataset import Collator, ConversationDataset, DataArgs, DatasetSpec
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.train.lora import LoRAConfig, merge_lora
    from vita_tpu_torch.train.step import TrainConfig
    from vita_tpu_torch.train.trainer import RunConfig, Trainer, load_state

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch; pass --device cpu to run on the CPU")
    if args.mesh is not None:
        raise NotImplementedError("--mesh (sharded training) is not ported yet (ROADMAP A11)")

    if args.model == "tiny-random":
        cfg = vita.VITAConfig.tiny()
        params = vita.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
        tok = ByteTokenizer()
        encode, bos_id, eos_id, pad_id = tok.encode, tok.bos_id, tok.eos_id, 0
    else:
        cfg, params = checkpoint.load_vita_checkpoint(args.model, device)
        hf_tok = load_hf_tokenizer(args.model)
        encode = lambda s: hf_tok(s).input_ids
        bos_id, eos_id, pad_id = hf_tok.bos_token_id, hf_tok.eos_token_id, hf_tok.pad_token_id

    if args.pretrain_mm_adapter:
        checkpoint.load_adapter_into(params, args.pretrain_mm_adapter)
    if args.whale_init:
        params = checkpoint.load_whale_torch_checkpoint(params, args.whale_init)
    if args.lora_from:
        params = merge_lora(params, load_state(args.lora_from, device=device),
                            LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha))

    stage = {
        "pretrain_mlp": TrainConfig.stage1_pretrain_mlp,
        "finetune": TrainConfig.stage2_finetune,
        "finetune_task": TrainConfig.stage3_task,
    }[args.stage]()
    if args.learning_rate is not None:
        stage = dataclasses.replace(stage, learning_rate=args.learning_rate)
    if args.projector_lr is not None:
        stage = dataclasses.replace(stage, projector_lr=args.projector_lr)

    ds = ConversationDataset(
        [DatasetSpec(d, args.data_ratio) for d in args.data],
        encode, bos_id, eos_id, pad_id=pad_id,
        args=DataArgs(
            image_size=cfg.vision.image_size,
            max_patches=args.max_patches,
            model_max_length=args.model_max_length,
            use_thumbnail=cfg.vision.image_size >= 448,
            # the dataset's tiling and per-group token count must match
            # the model's fusion config, or the merge misaligns
            vision_fusion=cfg.vision_fusion,
            image_tokens_per_group=cfg.image_tokens_per_group,
        ),
    )
    print(f"[data] {len(ds)} samples from {len(args.data)} file(s)")

    llm = cfg.llm
    if args.moe_mode:
        llm = dataclasses.replace(llm, moe_mode=args.moe_mode)
    if args.moe_chunk:
        llm = dataclasses.replace(llm, moe_chunk=args.moe_chunk)
    cfg = dataclasses.replace(cfg, llm=llm)
    run = RunConfig(output_dir=args.output_dir, batch_size=args.batch_size,
                    num_epochs=args.epochs, save_every_steps=args.save_every,
                    resume=not args.no_resume)
    trainer = Trainer(cfg, stage, run, params)
    log = trainer.train(ds, Collator(pad_id=pad_id or 0))
    trainer.save()
    if log:
        print(f"[done] {len(log)} steps, final loss {log[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
