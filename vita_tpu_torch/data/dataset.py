"""Conversation datasets, collation, and modality-grouped batching (a copy of
vita_tpu.data.dataset, so that the port loads no module of the reference
package; tests/test_torch_data.py holds it equal to the original).

Equivalent of the reference's LazySupervisedDataset /
DataCollatorForSupervisedDataset / LengthGroupedSampler
(vita/util/data_utils_video_audio_neg_frameCat.py:560-1204,
vita/train/vita_trainer.py:62-152), re-designed for static device shapes:

  - every sample leaves the dataset with media sentinels already expanded
    to exact feature counts (256/tile, conv-arithmetic for audio), so the
    device-side merge is a pure gather;
  - the collator pads token streams to a bucket length and tiles/audio to
    the batch max (dummy zero media keeps shapes static, mirroring the
    reference's dummy image [zeros]*5 / zeros(400,80) trick for
    non-multimodal rows, :1104-1117);
  - ``modality_grouped_indices`` reproduces the mm-vs-lang megabatch
    shuffling of the reference sampler (vita_trainer.py:62-97).

Dataset JSON schema (the reference's): a list of samples
``{"conversations": [{"from": "human"|"gpt", "value": ...}],
   "image"|"video"|"audio": path(s), "set": folder-key, "inserted_id": k?}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vita_tpu_torch.constants import (
    AUDIO_TOKEN_INDEX,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    IMAGE_TOKENS_PER_PATCH,
)
from vita_tpu_torch.data.audio import wav_to_features
from vita_tpu_torch.data.image import dynamic_tile, normalize
from vita_tpu_torch.data.preprocess import build_training_sample, normalize_media_tokens
from vita_tpu_torch.tokenization import audio_token_count

DUMMY_AUDIO_FRAMES = 400


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    chat_path: str
    data_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class DataArgs:
    image_size: int = 448
    min_patches: int = 1
    max_patches: int = 12
    use_thumbnail: bool = True
    model_max_length: int = 8192
    is_multimodal: bool = True
    expand_media: bool = True  # expand sentinels to exact feature counts
    # 'patch' (InternVL tiling) or 'framecat' (5-tuple mosaic groups for
    # both images and video; must match VITAConfig.vision_fusion)
    vision_fusion: str = "patch"
    # LLM tokens per tile group — must match VITAConfig.image_tokens_per_group
    # (reducing projectors emit 64, not 256; a mismatch silently misaligns
    # the cumsum-gather fusion)
    image_tokens_per_group: int = IMAGE_TOKENS_PER_PATCH

    @property
    def group_tiles(self) -> int:
        return 5 if self.vision_fusion == "framecat" else 1


class ConversationDataset:
    """Lazy JSON conversation dataset."""

    def __init__(
        self,
        specs: Sequence[DatasetSpec],
        encode: Callable[[str], List[int]],
        bos_id: int,
        eos_id: int,
        folder_dict: Optional[Dict[str, str]] = None,
        audio_folder: str = "",
        args: DataArgs = DataArgs(),
        seed: int = 42,
        pad_id: Optional[int] = None,
    ):
        self.encode = encode
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.folder_dict = folder_dict or {}
        self.audio_folder = audio_folder
        self.args = args

        rng = random.Random(seed)
        samples: List[Dict[str, Any]] = []
        for spec in specs:
            with open(spec.chat_path) as f:
                data = json.load(f)
            if spec.data_ratio < 1.0:
                data = rng.sample(data, int(len(data) * spec.data_ratio))
            samples.extend(data)
        rng.shuffle(samples)
        self.samples = samples

    def __len__(self) -> int:
        return len(self.samples)

    def modality_lengths(self) -> List[int]:
        """Signed proxy lengths: positive = multimodal, negative = lang
        (the reference's convention, ...neg_frameCat.py:602-611)."""
        out = []
        for s in self.samples:
            n = sum(len(t["value"].split()) for t in s["conversations"])
            mm = any(k in s for k in ("image", "video", "audio"))
            out.append(n if mm else -n)
        return out

    def _media_paths(self, sample: Dict, key: str) -> List[str]:
        """All media paths for ``key`` (the reference loads EVERY image /
        audio clip of a sample, neg_frameCat.py:776-840, 1007-1025)."""
        paths = sample[key]
        if not isinstance(paths, list):
            paths = [paths]
        set_id = sample.get("set")
        if isinstance(set_id, list):
            set_id = set_id[0]
        folder = self.folder_dict.get(set_id, "") if set_id else ""
        return [os.path.join(folder, p) if folder else p for p in paths]

    def _media_path(self, sample: Dict, key: str) -> str:
        return self._media_paths(sample, key)[0]

    def __getitem__(self, i: int) -> Dict[str, Any]:
        sample = self.samples[i]
        turns = sample["conversations"]
        has_image = "image" in sample or "video" in sample
        has_audio = "audio" in sample
        inserted_id = sample.get("inserted_id")

        tiles: List[np.ndarray] = []
        patch_nums: List[int] = [1]
        modality = "lang"
        # Media loads degrade gracefully: a broken file logs a warning and
        # falls back to dummy media (the reference prints-and-continues on
        # bad wavs, ...neg_frameCat.py:904-909 / whale init_model.py:36-39).
        framecat = self.args.vision_fusion == "framecat"
        if "image" in sample:
            modality = "image"
            patch_nums = []
            for img_path in self._media_paths(sample, "image"):
                try:
                    from PIL import Image

                    arr = np.asarray(Image.open(img_path).convert("RGB"))
                    if framecat:
                        from vita_tpu_torch.data.image import dynamic_tile_framecat

                        t = dynamic_tile_framecat(
                            arr, self.args.min_patches, self.args.max_patches,
                            self.args.image_size,
                        )
                    else:
                        t = dynamic_tile(
                            arr, self.args.min_patches, self.args.max_patches,
                            self.args.image_size, self.args.use_thumbnail,
                        )
                except Exception as e:
                    print(f"WARNING: cannot load image {img_path}: {e}")
                    t = [
                        np.zeros((self.args.image_size, self.args.image_size, 3),
                                 np.uint8)
                    ] * self.args.group_tiles
                tiles.extend(t)
                # one <image> sentinel per tile group per image (tiles/5
                # for framecat, ...neg_frameCat.py:1303; per-image entries
                # concatenate like the reference's patch_num list :776-840)
                patch_nums.append(len(t) // self.args.group_tiles)
        elif "video" in sample:
            modality = "video"
            try:
                if framecat:
                    from vita_tpu_torch.data.video import decode_video_frames_framecat

                    tiles = decode_video_frames_framecat(
                        self._media_path(sample, "video"), size=self.args.image_size
                    )
                else:
                    from vita_tpu_torch.data.video import decode_video_frames

                    tiles = decode_video_frames(
                        self._media_path(sample, "video"), size=self.args.image_size
                    )
            except Exception as e:
                print(f"WARNING: cannot load video {sample.get('video')}: {e}")
                tiles = [
                    np.zeros((self.args.image_size, self.args.image_size, 3), np.uint8)
                ] * (5 if framecat else 4)
            patch_nums = [1] * (len(tiles) // self.args.group_tiles)

        audio_clips: List[np.ndarray] = []
        if has_audio:
            paths = sample["audio"]
            if not isinstance(paths, list):
                paths = [paths]
            for path in paths:
                full = (
                    os.path.join(self.audio_folder, path)
                    if self.audio_folder else path
                )
                try:
                    feats, _ = wav_to_features(full)
                except Exception as e:
                    print(f"WARNING: cannot open {full}: {e}")
                    feats = np.zeros((DUMMY_AUDIO_FRAMES, 80), np.float32)
                audio_clips.append(feats)

        # media-keyed sample whose text carries no media token: degrade to
        # a lang sample (the mixtral_two renderer requires the token for
        # image/video modality) instead of aborting the loader
        if has_image and not any(
            DEFAULT_IMAGE_TOKEN in t["value"] or DEFAULT_VIDEO_TOKEN in t["value"]
            for t in turns
        ):
            print(f"WARNING: sample {i} has media but no media token; "
                  "treating as lang")
            has_image = False
            tiles = []
            modality = "lang"

        if not (has_image or has_audio):
            # pure-language samples bypass media normalization entirely —
            # the reference's lang branch calls preprocess() directly with
            # NO state tokens (neg_frameCat.py:1089-1093)
            norm = turns
        elif "video" in sample:
            norm = normalize_media_tokens(
                turns, image_token_num=len(tiles) // self.args.group_tiles,
                patch_nums=patch_nums, inserted_id=inserted_id,
            )
        else:
            norm = normalize_media_tokens(
                turns, patch_nums=patch_nums, inserted_id=inserted_id
            )
        input_ids, labels = build_training_sample(
            norm, self.encode, modality, has_media=has_image or has_audio,
            bos_id=self.bos_id, eos_id=self.eos_id, pad_id=self.pad_id,
            model_max_length=self.args.model_max_length,
            end_tag=sample.get("end_tag", True),
        )

        out: Dict[str, Any] = {"modality": modality}
        if tiles:
            out["images"] = normalize(tiles)
        elif self.args.is_multimodal:
            # dummy media keeps shapes static; framecat needs a whole
            # 5-tuple (the reference's [zeros]*5, ...neg_frameCat.py:1104)
            out["images"] = np.zeros(
                (self.args.group_tiles, self.args.image_size, self.args.image_size, 3),
                np.float32,
            )
        if audio_clips:
            out["audio"] = audio_clips[0]
            if len(audio_clips) > 1:
                out["audio_clips"] = audio_clips  # multi-clip (collator)
        elif self.args.is_multimodal:
            out["audio"] = np.zeros((DUMMY_AUDIO_FRAMES, 80), np.float32)

        if self.args.expand_media:
            input_ids, labels = expand_sample(
                input_ids, labels,
                image_slots=self.args.image_tokens_per_group,
                audio_slots=[audio_token_count(len(c)) for c in audio_clips]
                if has_audio else 0,
            )
        out["input_ids"] = input_ids
        out["labels"] = labels
        return out


def expand_sample(
    input_ids: np.ndarray,
    labels: np.ndarray,
    image_slots: int,
    audio_slots,  # int (all sentinels) or per-clip counts consumed in order
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand each media sentinel to its feature count; labels get IGNORE.

    ``audio_slots`` as a sequence assigns the k-th <audio> sentinel the
    k-th clip's token count (the reference expands per clip in order,
    neg_frameCat.py:1007-1025); extra sentinels reuse the last count."""
    per_audio = list(audio_slots) if isinstance(audio_slots, (list, tuple)) else None
    ids_out: List[int] = []
    lab_out: List[int] = []
    k_aud = 0
    for t, l in zip(input_ids.tolist(), labels.tolist()):
        if t == IMAGE_TOKEN_INDEX:
            ids_out.extend([IMAGE_TOKEN_INDEX] * image_slots)
            lab_out.extend([IGNORE_INDEX] * image_slots)
        elif t == AUDIO_TOKEN_INDEX:
            if per_audio is not None:
                n = per_audio[min(k_aud, len(per_audio) - 1)] if per_audio else 1
                k_aud += 1
            else:
                n = audio_slots
            n = max(n, 1)
            ids_out.extend([AUDIO_TOKEN_INDEX] * n)
            lab_out.extend([IGNORE_INDEX] * n)
        else:
            ids_out.append(t)
            lab_out.append(l)
    return np.asarray(ids_out, np.int64), np.asarray(lab_out, np.int64)


@dataclasses.dataclass
class Collator:
    """Pad a list of samples into one static-shape batch."""

    pad_id: int
    buckets: Sequence[int] = (512, 1024, 2048, 4096, 9216)

    def __call__(self, samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        b = len(samples)
        longest = max(len(s["input_ids"]) for s in samples)
        seq = next((x for x in sorted(self.buckets) if x >= longest), longest)

        ids = np.full((b, seq), self.pad_id, np.int32)
        labels = np.full((b, seq), IGNORE_INDEX, np.int32)
        valid = np.zeros((b, seq), bool)
        for k, s in enumerate(samples):
            n = min(len(s["input_ids"]), seq)
            ids[k, :n] = s["input_ids"][:n]
            labels[k, :n] = s["labels"][:n]
            valid[k, :n] = True

        image_mask = ids == IMAGE_TOKEN_INDEX
        audio_mask = ids == AUDIO_TOKEN_INDEX
        safe = np.where(image_mask | audio_mask, 0, ids)

        batch: Dict[str, np.ndarray] = {
            "input_ids": safe.astype(np.int32),
            "labels": labels,
            "image_mask": image_mask,
            "audio_mask": audio_mask,
            "attn_valid": valid,
        }

        if any("images" in s for s in samples):
            max_tiles = max(s["images"].shape[0] for s in samples if "images" in s)
            shape = next(s["images"].shape[1:] for s in samples if "images" in s)
            imgs = np.zeros((b, max_tiles) + shape, np.float32)
            for k, s in enumerate(samples):
                if "images" in s:
                    imgs[k, : s["images"].shape[0]] = s["images"]
            batch["images"] = imgs.reshape((b * max_tiles,) + shape)
            batch["tiles_per_sample"] = np.array(max_tiles)

        if any("audio_clips" in s for s in samples):
            # multi-clip batch: ALL samples' clips stack on the leading
            # axis and audio_select (clip_idx,row_idx per token position)
            # addresses each sample's own clips in the global stack — the
            # same multi-clip merge serving uses (models/vita.py)
            from vita_tpu_torch.tokenization import audio_select_arrays, audio_token_count

            all_clips: List[np.ndarray] = []
            ci = np.zeros((b, seq), np.int32)
            ri = np.zeros((b, seq), np.int32)
            for k, s in enumerate(samples):
                clips = s.get("audio_clips") or ([s["audio"]] if "audio" in s else [])
                base = len(all_clips)
                if clips and audio_mask[k].any():
                    counts = [audio_token_count(len(c)) for c in clips]
                    c_k, r_k = audio_select_arrays(audio_mask[k], counts)
                    ci[k] = np.where(audio_mask[k], c_k + base, 0)
                    ri[k] = np.where(audio_mask[k], r_k, 0)
                all_clips.extend(clips)
            if not all_clips:
                all_clips = [np.zeros((1, 80), np.float32)]
            max_t = max(c.shape[0] for c in all_clips)
            audio = np.zeros((len(all_clips), max_t, 80), np.float32)
            lengths = np.zeros((len(all_clips),), np.int32)
            for j, c in enumerate(all_clips):
                audio[j, : c.shape[0]] = c
                lengths[j] = c.shape[0]
            batch["speech"] = audio
            batch["speech_lengths"] = lengths
            batch["audio_select_clip"] = ci
            batch["audio_select_row"] = ri
        elif any("audio" in s for s in samples):
            max_t = max(s["audio"].shape[0] for s in samples if "audio" in s)
            audio = np.zeros((b, max_t, 80), np.float32)
            lengths = np.zeros((b,), np.int32)
            for k, s in enumerate(samples):
                if "audio" in s:
                    audio[k, : s["audio"].shape[0]] = s["audio"]
                    lengths[k] = s["audio"].shape[0]
            batch["speech"] = audio
            batch["speech_lengths"] = lengths
        return batch


def modality_grouped_indices(
    lengths: Sequence[int], batch_size: int, rng: random.Random
) -> List[int]:
    """Shuffle so each batch is all-multimodal or all-lang, length-grouped
    within megabatches (vita_trainer.py:62-97 semantics)."""
    mm = [i for i, l in enumerate(lengths) if l > 0]
    lang = [i for i, l in enumerate(lengths) if l <= 0]
    if not mm or not lang:
        pool = mm or lang
        idx = list(pool)
        rng.shuffle(idx)
        return idx

    def megabatches(indices):
        shuffled = list(indices)
        rng.shuffle(shuffled)
        mega = batch_size * 50
        out = []
        for i in range(0, len(shuffled), mega):
            chunk = sorted(
                shuffled[i : i + mega], key=lambda j: abs(lengths[j]), reverse=True
            )
            out.extend(chunk)
        return [out[i : i + batch_size] for i in range(0, len(out), batch_size)]

    batches = megabatches(mm) + megabatches(lang)
    # keep incomplete batches at the end like the reference's additional_batch
    full = [bx for bx in batches if len(bx) == batch_size]
    tail = [j for bx in batches if len(bx) != batch_size for j in bx]
    rng.shuffle(full)
    return [j for bx in full for j in bx] + tail
