"""CLI inference demo on the PyTorch port: text / image / video / audio
queries (vita_tpu.cli).

Usage:
  python -m vita_tpu_torch.cli --model tiny-random --question "Hello"
  python -m vita_tpu_torch.cli --model tiny-random --device cpu --question "Hello"
  python -m vita_tpu_torch.cli --model tiny-random --image cat.jpg \
      --question "What is this?" --prefill-moe-mode gmm

The flags are those of ``python -m vita_tpu.cli`` plus ``--device``
(default ``cuda``; without a card the command stops rather than run on the
CPU). ``--model tiny-random`` runs ``VITAConfig.tiny()`` with weights drawn
from a seeded generator and a byte tokenizer: the full pipeline without
downloaded weights (the output is gibberish by construction). ``--model
<dir>`` loads a checkpoint directory (``checkpoint.load_vita_checkpoint``:
the HF deploy layout or the port's native one) and the tokenizer saved in
it (``load_hf_tokenizer``, through transformers). Prompts are
built as the reference builds them (the mixtral_two template of
vita_tpu_torch.constants, then vita_tpu_torch.tokenization); media files
are read by the port's copies of the reference's numpy loaders
(``vita_tpu_torch.data.image`` / ``video`` / ``audio``). Serving goes
through ``Generator``, or through the ``Engine`` for ``--kv-int8``.

Not ported yet: ``--mesh`` (sharded serving).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from vita_tpu_torch.constants import MIXTRAL_TWO
from vita_tpu_torch.tokenization import (
    audio_token_count,
    expand_media_sentinels,
    media_masks,
    tokenize_multimodal,
)

class ByteTokenizer:
    """Fallback tokenizer: bytes + offset, BOS=1, EOS=2."""

    bos_id, eos_id, offset = 1, 2, 3

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + [b + self.offset for b in text.encode()]

    def decode(self, ids) -> str:
        data = bytes(t - self.offset for t in ids if self.offset <= t < self.offset + 256)
        return data.decode(errors="replace")


def load_hf_tokenizer(path: str):
    """The tokenizer saved in the checkpoint directory ``path``
    (transformers' AutoTokenizer, imported here, from local files only)."""
    if not any(os.path.exists(os.path.join(path, f)) for f in
               ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")):
        raise FileNotFoundError(f"no tokenizer in the checkpoint directory {path!r} "
                                "(tokenizer.json, tokenizer_config.json or tokenizer.model)")
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, use_fast=True, local_files_only=True)


def build_prompt(question: str, modality: str, has_audio: bool) -> str:
    """One user turn in the mixtral_two conversation, cueing the bot."""
    parts = ["<image>"] if modality in ("image", "video") else []
    parts.append("<audio>" if has_audio else question)
    return MIXTRAL_TWO.render([("user", "\n".join(parts)), ("bot", "")], modality)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="VITA inference demo on the PyTorch port")
    p.add_argument("--model", required=True, help="checkpoint dir or 'tiny-random'")
    p.add_argument("--question", default="")
    p.add_argument("--image", default=None)
    p.add_argument("--video", default=None)
    p.add_argument("--audio", default=None)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.01)
    p.add_argument("--max-patches", type=int, default=12)
    p.add_argument("--max-len", type=int, default=4096)
    p.add_argument("--chunk-len", type=int, default=8,
                   help="decode tokens per host readback")
    p.add_argument("--vision-fusion", default=None, choices=["patch", "framecat"],
                   help="override vision fusion for tiny-random")
    p.add_argument("--decode-moe-mode", default=None,
                   choices=["dense", "capacity", "gather", "gather_q", "gather_q4"],
                   help="MoE path for decode steps (default: inherit model config)")
    p.add_argument("--mesh", type=int, nargs="+", metavar="AX", default=None,
                   help="serving mesh EXPERT MODEL [PIPE] (not ported)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache pages, served through the Engine")
    p.add_argument("--prefill-moe-mode", default=None,
                   choices=["dense", "capacity", "sort", "gmm"],
                   help="MoE dispatch for the prefill pass: gmm = grouped matmul, "
                        "exact with top-k-only FLOPs; sort = capacity-dropping")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from vita_tpu_torch.generate import GenerationConfig, Generator
    from vita_tpu_torch.models import vita

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch; pass --device cpu to run on the CPU")
    if args.mesh is not None:
        raise NotImplementedError("--mesh (sharded serving) is not ported yet (ROADMAP A11)")

    t0 = time.time()
    if args.model == "tiny-random":
        cfg = vita.VITAConfig.tiny(
            **({"vision_fusion": args.vision_fusion} if args.vision_fusion else {}))
        params = vita.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
        tok = ByteTokenizer()
        encode, eos_id, bos_id, decode = tok.encode, tok.eos_id, tok.bos_id, tok.decode
    else:
        from vita_tpu_torch.checkpoint import load_vita_checkpoint

        cfg, params = load_vita_checkpoint(args.model, device)
        hf_tok = load_hf_tokenizer(args.model)
        encode = lambda s: hf_tok(s).input_ids
        bos_id, eos_id = hf_tok.bos_token_id, hf_tok.eos_token_id
        decode = lambda ids: hf_tok.decode(ids, skip_special_tokens=True)
    print(f"[load] {time.time()-t0:.1f}s")

    if args.image and args.video:
        p.error("--image and --video are mutually exclusive")
    if args.audio and args.question:
        # the reference asserts exactly one of audio/question
        p.error("provide either --audio or --question, not both "
                "(the audio clip IS the question)")
    modality = "image" if args.image else "video" if args.video else "lang"
    has_audio = args.audio is not None

    framecat = cfg.vision_fusion == "framecat"
    group = 5 if framecat else 1
    images = None
    n_groups = 0  # <image> sentinels (tile 5-tuples under framecat)
    if args.image:
        from PIL import Image

        from vita_tpu_torch.data.image import dynamic_tile, dynamic_tile_framecat, normalize

        arr = np.asarray(Image.open(args.image).convert("RGB"))
        if framecat:
            tiles = dynamic_tile_framecat(arr, 1, args.max_patches, cfg.vision.image_size)
        elif args.model == "tiny-random":  # the tiny tower takes one tile of its own size
            tiles = [np.asarray(Image.fromarray(arr).resize((cfg.vision.image_size,) * 2))]
        else:
            tiles = dynamic_tile(arr, 1, args.max_patches, cfg.vision.image_size, True)
        images = normalize(tiles)
        n_groups = len(tiles) // group
    elif args.video:
        from vita_tpu_torch.data.image import normalize
        from vita_tpu_torch.data.video import decode_video_frames, decode_video_frames_framecat

        if framecat:
            frames = decode_video_frames_framecat(args.video, size=cfg.vision.image_size)
        else:
            frames = decode_video_frames(args.video, size=cfg.vision.image_size)
        images = normalize(list(frames))
        n_groups = len(frames) // group

    speech = speech_len = None
    if has_audio:
        from vita_tpu_torch.data.audio import wav_to_features

        speech, speech_len = wav_to_features(args.audio)

    prompt = build_prompt(args.question, modality, has_audio)
    ids = tokenize_multimodal(prompt, encode, bos_id=bos_id)
    img_counts = [n_groups * cfg.image_tokens_per_group] if images is not None else []
    aud_counts = [audio_token_count(speech_len)] if has_audio else []
    expanded = expand_media_sentinels(ids, img_counts, aud_counts)
    safe, im, am = media_masks(np.array(expanded))

    temperature = 0.0 if args.temperature <= 0.01 else args.temperature
    first_token_t = [None]

    def on_token(_):
        if first_token_t[0] is None:
            first_token_t[0] = time.time()

    media = dict(image_mask=im if images is not None else None,
                 audio_mask=am if has_audio else None,
                 images=images, speech=speech, speech_length=speech_len)
    if args.kv_int8:
        from vita_tpu_torch.serve.engine import Engine, Request

        eng = Engine(params, cfg, n_slots=1, max_len=args.max_len,
                     decode_chunk_len=args.chunk_len,
                     decode_moe_mode=args.decode_moe_mode,
                     prefill_moe_mode=args.prefill_moe_mode,
                     kv_int8=True, page_size=128, device=device)
        t1 = time.time()
        req = Request(input_ids=safe, max_new_tokens=args.max_new_tokens,
                      temperature=temperature, eos_id=eos_id, on_token=on_token, **media)
        eng.submit(req)
        eng.run_until_idle()
        out = req.tokens
    else:
        gen = Generator(params, cfg, max_len=args.max_len, chunk_len=args.chunk_len,
                        decode_moe_mode=args.decode_moe_mode,
                        prefill_moe_mode=args.prefill_moe_mode, device=device)
        gcfg = GenerationConfig(max_new_tokens=args.max_new_tokens,
                                temperature=temperature, eos_id=eos_id)
        t1 = time.time()
        out = gen.generate(safe, gen=gcfg, on_token=on_token, **media)
    t2 = time.time()
    text = decode(out)
    ttft = (first_token_t[0] or t2) - t1
    print(f"[prompt tokens] {len(expanded)}  [new tokens] {len(out)}")
    print(f"[TTFT] {ttft*1000:.0f} ms  [decode] {(t2-t1):.2f}s "
          f"({len(out)/max(t2-t1,1e-9):.1f} tok/s)")
    print("=" * 40)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
