"""PyTorch port: the copied host modules (vita_tpu_torch.constants and
vita_tpu_torch.data.*) against the originals in vita_tpu: the same
samples, batches, features and tiles from the same inputs, exactly."""

import json
import random
import wave

import numpy as np
import pytest

from vita_tpu import constants as j_const
from vita_tpu.conversation import MIXTRAL_TWO as J_MIXTRAL_TWO
from vita_tpu.data import audio as j_audio
from vita_tpu.data import dataset as j_ds
from vita_tpu.data import image as j_image
from vita_tpu.data import loader as j_loader
from vita_tpu.data import preprocess as j_pre
from vita_tpu_torch import constants
from vita_tpu_torch.data import audio, dataset, image, loader, preprocess


def test_constants_and_template_match():
    for name in ("MAX_IMAGE_LENGTH", "MIN_IMAGE_LENGTH", "IGNORE_INDEX", "IMAGE_TOKEN_INDEX",
                 "AUDIO_TOKEN_INDEX", "DEFAULT_IMAGE_TOKEN", "DEFAULT_VIDEO_TOKEN",
                 "DEFAULT_AUDIO_TOKEN", "STATE_TOKEN_AUDIO", "STATE_TOKEN_NOISY",
                 "STATE_TOKEN_TEXT", "IMAGE_TOKENS_PER_PATCH"):
        assert getattr(constants, name) == getattr(j_const, name), name
    t2, j2 = constants.MIXTRAL_TWO, J_MIXTRAL_TWO
    assert (t2.roles, t2.sep, t2.sep2, t2.system) == (j2.roles, j2.sep, j2.sep2, j2.system)
    for msgs, modality in (([("user", "hi"), ("bot", "")], "lang"),
                           ([("user", "<image>\nq"), ("bot", "a"), ("user", "b")], "video"),
                           ([("user", "<image>x"), ("bot", "")], "lang"),
                           ([("user", "x")], "image"), ([("user", "x")], "nope")):
        try:
            want = j2.render(msgs, modality)
        except ValueError:
            with pytest.raises(ValueError):
                t2.render(msgs, modality)
            continue
        assert t2.render(msgs, modality) == want


def _wav(path, seconds, seed, width=2, rate=16000):
    rng = np.random.default_rng(seed)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes((rng.standard_normal(int(rate * seconds)) * 3000).astype(np.int16).tobytes())
    return str(path)


def _encode(s):
    return [1] + [3 if w == "</s>" else 100 + (sum(map(ord, w)) % 400)
                  for w in s.replace("</s>", " </s> ").split()]


def _samples(tmp_path):
    a1, a2 = _wav(tmp_path / "a1.wav", 0.6, 1), _wav(tmp_path / "a2.wav", 1.1, 2)
    return [
        {"conversations": [{"from": "human", "value": "<audio>\n"},
                           {"from": "gpt", "value": "one two"}], "audio": a1},
        {"conversations": [{"from": "human", "value": "hi there"},
                           {"from": "gpt", "value": "yo"},
                           {"from": "human", "value": "more"},
                           {"from": "gpt", "value": "sure thing"}]},
        {"conversations": [{"from": "human", "value": "<audio>\nfirst"},
                           {"from": "gpt", "value": "x"},
                           {"from": "human", "value": "<audio>\n"},
                           {"from": "gpt", "value": "y z"}], "audio": [a1, a2]},
        {"conversations": [{"from": "human", "value": "<audio>\n"},
                           {"from": "gpt", "value": "noise"}], "audio": a2, "inserted_id": 1},
        {"conversations": [{"from": "human", "value": "<audio>\n"},
                           {"from": "gpt", "value": "missing"}],
         "audio": str(tmp_path / "missing.wav")},
    ]


def _assert_same(a, b, where=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("data_ratio", [1.0, 0.6])
def test_dataset_and_collator_match(tmp_path, data_ratio):
    """Text and audio samples (one clip, two clips, a noisy-turn
    inserted_id, an unreadable wav that falls back to dummy audio) through
    ConversationDataset, then Collator batches, modality-grouped order and
    the PrefetchLoader: equal to vita_tpu.data's."""
    chat = tmp_path / "chat.json"
    chat.write_text(json.dumps(_samples(tmp_path)))
    kw = dict(image_size=56, max_patches=1, use_thumbnail=False)
    tds = dataset.ConversationDataset([dataset.DatasetSpec(str(chat), data_ratio)], _encode, 1, 2,
                                      pad_id=0, args=dataset.DataArgs(**kw))
    jds = j_ds.ConversationDataset([j_ds.DatasetSpec(str(chat), data_ratio)], _encode, 1, 2,
                                   pad_id=0, args=j_ds.DataArgs(**kw))
    assert len(tds) == len(jds) and tds.modality_lengths() == jds.modality_lengths()
    items = [tds[i] for i in range(len(tds))]
    for i, got in enumerate(items):
        _assert_same(got, jds[i], f"sample {i}")
    for bucket in ((512, 9216), (16, 24, 9216)):
        _assert_same(dataset.Collator(0, bucket)(items), j_ds.Collator(0, bucket)(items),
                     f"batch {bucket}")
    order = dataset.modality_grouped_indices(tds.modality_lengths() * 30, 4, random.Random(3))
    assert order == j_ds.modality_grouped_indices(jds.modality_lengths() * 30, 4,
                                                  random.Random(3))
    got = list(loader.PrefetchLoader(tds, [1, 0, 2], 2, dataset.Collator(0), num_workers=2))
    want = list(j_loader.PrefetchLoader(jds, [1, 0, 2], 2, j_ds.Collator(0), num_workers=2))
    _assert_same(got, want, "loader")


def test_preprocess_matches():
    turns = [{"from": "human", "value": "what\n<image><image>"},
             {"from": "gpt", "value": "a cat"},
             {"from": "human", "value": "<audio>\nand <video>"},
             {"from": "gpt", "value": "ok"}]
    for kw in (dict(patch_nums=[2]), dict(patch_nums=[2], image_token_num=3, inserted_id=3)):
        got = preprocess.normalize_media_tokens(turns, **kw)
        assert got == j_pre.normalize_media_tokens(turns, **kw)
        for pad in (0, None):
            a = preprocess.build_training_sample(got, _encode, "image", True, 1, 2, pad_id=pad)
            b = j_pre.build_training_sample(got, _encode, "image", True, 1, 2, pad_id=pad)
            _assert_same(a, b)
    ids = np.array([1, -200, 5, -500, 6, -500], np.int64)
    _assert_same(dataset.expand_sample(ids, ids.copy(), 3, [2, 4]),
                 j_ds.expand_sample(ids, ids.copy(), 3, [2, 4]))


def test_audio_and_image_helpers_match(tmp_path):
    for width, rate in ((2, 16000), (1, 16000), (2, 8000)):
        path = _wav(tmp_path / f"w{width}_{rate}.wav", 0.4, 5, width=width, rate=rate)
        _assert_same(audio.wav_to_features(path), j_audio.wav_to_features(path))
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (70, 130, 3), np.uint8)
    for fn in ("dynamic_tile", "dynamic_tile_framecat"):
        got = getattr(image, fn)(img, 1, 6, 28)
        _assert_same(got, getattr(j_image, fn)(img, 1, 6, 28), fn)
    _assert_same(image.normalize(got), j_image.normalize(got))
    frames = [rng.integers(0, 255, (28, 28, 3), np.uint8) for _ in range(8)]
    _assert_same(image.assemble_framecat_frames(frames), j_image.assemble_framecat_frames(frames))
    for args in ((40, 25.0), (300, 29.97, 2.0, 8, 4)):
        _assert_same(image.sample_video_frames(*args), j_image.sample_video_frames(*args))
    _assert_same(image.sample_video_frames_framecat(90, 30.0),
                 j_image.sample_video_frames_framecat(90, 30.0))
