"""Data curation tools: `python -m vita_tpu_torch.data.tools <command>`.

Consolidates the reference's data_tools/ scripts (16 standalone files —
check_json.py, check_image_lost.py / check_video_lost.py /
check_audio_lost.py, check_image_space_ratio.py, statistics_token_num_*,
concat_data_* variants) into one CLI:

  check-json   — validate conversation structure (roles alternate,
                 human/gpt tags, media token placement)
  check-media  — referenced image/video/audio files exist; flag images
                 with aspect ratio > 12 (the reference's outlier filter)
  token-stats  — token-length statistics per tiling scheme (patch or
                 frameCat), budget violations vs --max-length
  concat       — merge short conversations into longer multi-round samples
                 under a token budget (concat_data_* semantics)
  remove-lost  — write a cleaned JSON with samples whose media files are
                 missing dropped (rm_lost_{image,video,audio}_in_json.py)
  fix-json     — repair common annotation defects in place: drop samples
                 with broken conversations, strip empty turns, normalize
                 role tags (check_json.py's issues, but fixing)
  data-stats   — per-file sample/modality counts + audio duration totals
                 (statistics_data_num.py / statistics_audio_duration.py /
                 statistics_image_num.py)

A copy of vita_tpu.data.tools, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from vita_tpu_torch.constants import (
    DEFAULT_AUDIO_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IMAGE_TOKENS_PER_PATCH,
)


def _load(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise SystemExit(f"{path}: top level must be a list")
    return data


def cmd_check_json(args) -> int:
    bad = 0
    for path in args.data:
        data = _load(path)
        for i, sample in enumerate(data):
            errs = []
            conv = sample.get("conversations")
            if not isinstance(conv, list) or not conv:
                errs.append("missing conversations")
            else:
                for j, turn in enumerate(conv):
                    frm = turn.get("from")
                    if frm not in ("human", "gpt"):
                        errs.append(f"turn {j}: bad from={frm!r}")
                    if not isinstance(turn.get("value"), str):
                        errs.append(f"turn {j}: value not a string")
                start = 0 if conv[0].get("from") == "human" else 1
                for j, turn in enumerate(conv[start:]):
                    want = "human" if j % 2 == 0 else "gpt"
                    if turn.get("from") != want:
                        errs.append(f"turn {start + j}: expected {want}")
                        break
                n_img_tokens = sum(t.get("value", "").count(DEFAULT_IMAGE_TOKEN) for t in conv)
                if "image" in sample:
                    n_files = len(sample["image"]) if isinstance(sample["image"], list) else 1
                    if n_img_tokens != n_files:
                        errs.append(f"{n_img_tokens} <image> tokens vs {n_files} image files")
                if any(t.get("from") == "gpt" and DEFAULT_IMAGE_TOKEN in t.get("value", "") for t in conv):
                    errs.append("<image> inside a gpt turn")
            if errs:
                bad += 1
                print(f"{path}[{i}] (id={sample.get('id', '?')}): " + "; ".join(errs))
    print(f"check-json: {bad} invalid samples")
    return 1 if bad else 0


def cmd_check_media(args) -> int:
    folder = {}
    if args.folder_map:
        with open(args.folder_map) as f:
            folder = json.load(f)
    missing = ratio_bad = 0
    for path in args.data:
        for i, sample in enumerate(_load(path)):
            for key in ("image", "video", "audio"):
                if key not in sample:
                    continue
                files = sample[key] if isinstance(sample[key], list) else [sample[key]]
                sets = sample.get("set")
                sets = sets if isinstance(sets, list) else [sets] * len(files)
                for f_, set_id in zip(files, sets):
                    base = folder.get(set_id, args.media_root or "")
                    full = os.path.join(base, f_) if base else f_
                    if not os.path.exists(full):
                        missing += 1
                        print(f"{path}[{i}]: missing {key} {full}")
                    elif key == "image" and args.check_ratio:
                        from PIL import Image

                        w, h = Image.open(full).size
                        if max(w / h, h / w) > args.max_ratio:
                            ratio_bad += 1
                            print(f"{path}[{i}]: aspect ratio {max(w/h, h/w):.1f} > {args.max_ratio}")
    print(f"check-media: {missing} missing, {ratio_bad} bad-ratio")
    return 1 if missing else 0


def _estimate_tokens(sample: Dict[str, Any], scheme: str, max_patches: int) -> int:
    """Token-count estimate per tiling scheme (statistics_token_num_*.py):
    words as text proxy + exact media slot counts."""
    n = 0
    for t in sample["conversations"]:
        v = t["value"]
        n_img = v.count(DEFAULT_IMAGE_TOKEN) + v.count(DEFAULT_VIDEO_TOKEN)
        n_aud = v.count(DEFAULT_AUDIO_TOKEN)
        text = v.replace(DEFAULT_IMAGE_TOKEN, "").replace(DEFAULT_VIDEO_TOKEN, "")
        text = text.replace(DEFAULT_AUDIO_TOKEN, "")
        n += len(text.split()) + 4  # role/sep overhead
        if n_img:
            if "video" in sample:
                n += n_img * IMAGE_TOKENS_PER_PATCH
            elif scheme == "framecat":
                # multiples of 5 per 2x2 supertile; estimate ceil to even grid
                n += 5 * IMAGE_TOKENS_PER_PATCH * n_img
            else:
                n += (max_patches + 1) * IMAGE_TOKENS_PER_PATCH * n_img
        n += n_aud * 50  # ~4 s clip
    return n


def cmd_token_stats(args) -> int:
    counts = []
    over = 0
    for path in args.data:
        for sample in _load(path):
            n = _estimate_tokens(sample, args.scheme, args.max_patches)
            counts.append(n)
            if n > args.max_length:
                over += 1
    counts = np.asarray(counts)
    if len(counts):
        print(
            f"token-stats ({args.scheme}): n={len(counts)} mean={counts.mean():.0f} "
            f"p50={np.percentile(counts, 50):.0f} p95={np.percentile(counts, 95):.0f} "
            f"max={counts.max()} over_{args.max_length}={over}"
        )
    return 0


def cmd_concat(args) -> int:
    """Merge consecutive short samples into multi-round conversations while
    the estimated token total stays under budget (concat_data_*.py)."""
    out: List[Dict[str, Any]] = []
    for path in args.data:
        data = _load(path)
        cur: Optional[Dict[str, Any]] = None
        cur_tokens = 0
        for sample in data:
            has_media = any(k in sample for k in ("image", "video", "audio"))
            n = _estimate_tokens(sample, args.scheme, args.max_patches)
            if cur is None or has_media or cur_tokens + n > args.max_length:
                if cur is not None:
                    out.append(cur)
                cur = dict(sample)
                cur["conversations"] = list(sample["conversations"])
                cur_tokens = n
            else:
                cur["conversations"] = cur["conversations"] + sample["conversations"]
                cur_tokens += n
        if cur is not None:
            out.append(cur)
    with open(args.output, "w") as f:
        json.dump(out, f, ensure_ascii=False)
    print(f"concat: wrote {len(out)} samples to {args.output}")
    return 0


def _media_files(sample, folder, media_root):
    """Yield (key, full_path) for every media reference in a sample."""
    for key in ("image", "video", "audio"):
        if key not in sample:
            continue
        files = sample[key] if isinstance(sample[key], list) else [sample[key]]
        sets = sample.get("set")
        sets = sets if isinstance(sets, list) else [sets] * len(files)
        for f_, set_id in zip(files, sets):
            base = folder.get(set_id, media_root or "")
            yield key, (os.path.join(base, f_) if base else f_)


def cmd_remove_lost(args) -> int:
    """rm_lost_*_in_json.py: drop samples referencing missing media files
    and write the cleaned list."""
    folder = {}
    if args.folder_map:
        with open(args.folder_map) as f:
            folder = json.load(f)
    kept, dropped = [], 0
    for path in args.data:
        for sample in _load(path):
            ok = all(
                os.path.exists(full)
                for _, full in _media_files(sample, folder, args.media_root)
            )
            if ok:
                kept.append(sample)
            else:
                dropped += 1
    with open(args.output, "w") as f:
        json.dump(kept, f, ensure_ascii=False)
    print(f"remove-lost: kept {len(kept)}, dropped {dropped} -> {args.output}")
    return 0


def cmd_fix_json(args) -> int:
    """Repair annotation defects the checkers flag: normalize role tags,
    drop empty turns, drop samples that do not start with a human turn or
    whose roles do not alternate after repair."""
    role_map = {"user": "human", "human": "human", "assistant": "gpt",
                "gpt": "gpt", "bot": "gpt"}
    kept, dropped, repaired = [], 0, 0
    for path in args.data:
        for sample in _load(path):
            conv = sample.get("conversations")
            if not isinstance(conv, list) or not conv:
                dropped += 1
                continue
            fixed, changed = [], False
            for t in conv:
                if not isinstance(t, dict):
                    changed = True
                    continue
                role = role_map.get(str(t.get("from", "")).lower())
                text = t.get("value")
                if role is None or not isinstance(text, str) or not text.strip():
                    changed = True
                    continue
                if role != t.get("from"):
                    changed = True
                fixed.append({**t, "from": role, "value": text})
            ok = (
                fixed
                and fixed[0]["from"] == "human"
                and all(
                    fixed[i]["from"] != fixed[i + 1]["from"]
                    for i in range(len(fixed) - 1)
                )
            )
            if not ok:
                dropped += 1
                continue
            if changed:
                repaired += 1
            kept.append({**sample, "conversations": fixed})
    with open(args.output, "w") as f:
        json.dump(kept, f, ensure_ascii=False)
    print(f"fix-json: kept {len(kept)} ({repaired} repaired), dropped {dropped} "
          f"-> {args.output}")
    return 0


def cmd_data_stats(args) -> int:
    """statistics_data_num / statistics_image_num / statistics_audio_duration."""
    folder = {}
    if args.folder_map:
        with open(args.folder_map) as f:
            folder = json.load(f)
    for path in args.data:
        data = _load(path)
        counts = {"image": 0, "video": 0, "audio": 0, "lang": 0}
        n_images = 0
        audio_s = 0.0
        for sample in data:
            mods = [k for k in ("image", "video", "audio") if k in sample]
            for m in mods:
                counts[m] += 1
            if not mods:
                counts["lang"] += 1
            files = sample.get("image", [])
            n_images += len(files) if isinstance(files, list) else 1
            for key, full in _media_files(sample, folder, args.media_root):
                if key == "audio" and os.path.exists(full):
                    try:
                        import wave

                        with wave.open(full) as w:
                            audio_s += w.getnframes() / w.getframerate()
                    except Exception:
                        pass
        print(f"{path}: {len(data)} samples "
              f"(image {counts['image']}, video {counts['video']}, "
              f"audio {counts['audio']}, lang {counts['lang']}); "
              f"{n_images} image refs; {audio_s:.1f}s audio")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vita_tpu_torch.data.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("check-json")
    c.add_argument("data", nargs="+")
    c.set_defaults(fn=cmd_check_json)

    c = sub.add_parser("check-media")
    c.add_argument("data", nargs="+")
    c.add_argument("--media-root", default="")
    c.add_argument("--folder-map", default=None, help="JSON: set name -> folder")
    c.add_argument("--check-ratio", action="store_true")
    c.add_argument("--max-ratio", type=float, default=12.0)
    c.set_defaults(fn=cmd_check_media)

    c = sub.add_parser("token-stats")
    c.add_argument("data", nargs="+")
    c.add_argument("--scheme", choices=["patch", "framecat"], default="patch")
    c.add_argument("--max-patches", type=int, default=12)
    c.add_argument("--max-length", type=int, default=9100)
    c.set_defaults(fn=cmd_token_stats)

    c = sub.add_parser("concat")
    c.add_argument("data", nargs="+")
    c.add_argument("--output", required=True)
    c.add_argument("--scheme", choices=["patch", "framecat"], default="patch")
    c.add_argument("--max-patches", type=int, default=12)
    c.add_argument("--max-length", type=int, default=6000)
    c.set_defaults(fn=cmd_concat)

    c = sub.add_parser("remove-lost")
    c.add_argument("data", nargs="+")
    c.add_argument("--output", required=True)
    c.add_argument("--media-root", default="")
    c.add_argument("--folder-map", default=None)
    c.set_defaults(fn=cmd_remove_lost)

    c = sub.add_parser("fix-json")
    c.add_argument("data", nargs="+")
    c.add_argument("--output", required=True)
    c.set_defaults(fn=cmd_fix_json)

    c = sub.add_parser("data-stats")
    c.add_argument("data", nargs="+")
    c.add_argument("--media-root", default="")
    c.add_argument("--folder-map", default=None)
    c.set_defaults(fn=cmd_data_stats)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
