"""PyTorch port: the copied host modules (vita_tpu_torch.constants and
vita_tpu_torch.data.*) against the originals in vita_tpu: the same
samples, batches, features and tiles from the same inputs, exactly."""

import dataclasses
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


# --------------------------------------------------------------------------
# the serving copies: conversation, serve/{history,vad,vad_model,tts,camera},
# data/tools and the VAD weights
# --------------------------------------------------------------------------
COPIES = ["conversation", "serve/history", "serve/vad", "serve/vad_model", "serve/tts",
          "serve/camera", "data/tools"]
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _code(path, package):
    """A module's source without its docstring, with the package name
    written as ``vita_tpu``."""
    import ast

    src = path.read_text()
    doc = ast.get_docstring(ast.parse(src), clean=False)
    body = src.split('"""' + doc + '"""', 1)[1]
    return body.replace(package + ".", "vita_tpu.")


@pytest.mark.parametrize("name", COPIES)
def test_copied_module_code_equals_the_original(name):
    got = _code(ROOT / "vita_tpu_torch" / f"{name}.py", "vita_tpu_torch")
    assert got == _code(ROOT / "vita_tpu" / f"{name}.py", "vita_tpu")


def test_vad_weights_are_byte_equal_and_found_in_the_port():
    from vita_tpu.serve import vad_model as j_vad_model
    from vita_tpu_torch.serve import vad, vad_model

    assert (ROOT / "vita_tpu_torch/serve/vad_weights.npz").read_bytes() == \
        (ROOT / "vita_tpu/serve/vad_weights.npz").read_bytes()
    assert vad_model.WEIGHTS_PATH == str(ROOT / "vita_tpu_torch/serve/vad_weights.npz")
    assert j_vad_model.WEIGHTS_PATH != vad_model.WEIGHTS_PATH
    rng = np.random.default_rng(4)
    chunks = ([vad_model.synth_speech(rng) for _ in range(5)]
              + [vad_model.synth_noise(rng) for _ in range(5)])
    prob, jprob = vad.default_prob_fn(), j_vad_model.load_trained_vad()
    assert [prob(c) for c in chunks] == [jprob(c) for c in chunks]
    assert [vad.energy_vad_prob(c) for c in chunks] == [
        __import__("vita_tpu.serve.vad", fromlist=["x"]).energy_vad_prob(c) for c in chunks]


def test_conversation_goldens_and_dialog_match():
    from vita_tpu import conversation as j_conv
    from vita_tpu_torch import conversation

    goldens = json.loads((ROOT / "tests/goldens/conversation.json").read_text())
    for case in goldens:
        msgs = [(r, m or "") for r, m in case["messages"]]
        modality = case["modality"] if case["template"] == "mixtral_two" else "lang"
        got = conversation.TEMPLATES[case["template"]].render(msgs, modality)
        assert got == case["prompt"] == j_conv.TEMPLATES[case["template"]].render(msgs, modality)
    d = conversation.Dialog(conversation.MIXTRAL_TWO).user("Hello!").assistant("hi").user("q")
    assert d.render("lang") == j_conv.Dialog(j_conv.MIXTRAL_TWO).user("Hello!").assistant(
        "hi").user("q").render("lang")
    assert conversation.MIXTRAL_TWO.render([("user", "x")]) == constants.MIXTRAL_TWO.render(
        [("user", "x")])


def test_history_merges_match():
    from vita_tpu.serve import history as j_hist
    from vita_tpu_torch.serve import history

    img, cur = np.zeros((1, 8, 8, 3), np.float32), np.ones((1, 8, 8, 3), np.float32)
    sp = np.ones((40, 80), np.float32)
    cases = [
        ([], "hello", {}),
        ([("<image>\nwhat is this?", "<3>a cat", dict(images=img, image_slot_counts=(4,))),
          ("and its color?", "<3>black", {})], "how many legs?", {}),
        ([("<image>\nlook", "<3>ok", dict(images=img, image_slot_counts=(8,)))], "and now?",
         dict(skip_history_vision=True)),
        ([("a <image> b", "<3>r1", dict(images=img, image_slot_counts=(4,)))], "c <image> d",
         dict(images=cur, image_slot_counts=(4,), image_tokens_to_front=True)),
        ([("<audio>", "<2>noise", dict(speech=sp * 0, speech_length=40)),
          ("<audio>", "<1>real answer", dict(speech=sp, speech_length=40))], "next", {}),
        ([("<audio>", "<1>a", dict(encoded=sp[:11, :32], encoded_length=11))], "<audio>",
         dict(encoded=sp[:7, :32], encoded_length=7)),
    ]
    for turns, text, kw in cases:
        got = history.merge_current_and_history(
            [history.HistoryTurn(p, r, **m) for p, r, m in turns], text, **kw)
        want = j_hist.merge_current_and_history(
            [j_hist.HistoryTurn(p, r, **m) for p, r, m in turns], text, **kw)
        _assert_same(dataclasses.asdict(got), dataclasses.asdict(want), text)
    s, js = history.ChatSession(limit=2), j_hist.ChatSession(limit=2)
    for i in range(3):
        s.add(history.HistoryTurn(f"q{i}", f"<1>a{i}"))
        js.add(j_hist.HistoryTurn(f"q{i}", f"<1>a{i}"))
    assert s.merge("next").prompt == js.merge("next").prompt


def _vad_segments(vad_mod, chunks, **cfg):
    v = vad_mod.StreamingVAD(vad_mod.VADConfig(**cfg))
    return [(i, seg) for i, c in enumerate(chunks) if (seg := v.process(c)) is not None]


def test_vad_segments_match():
    """Tone speech with energy detection, synthetic speech and loud noise
    with the trained model: the same segments at the same chunks."""
    from vita_tpu.serve import vad as j_vad
    from vita_tpu_torch.serve import vad, vad_model

    n = vad.CHUNK_SAMPLES
    tone = np.sin(2 * np.pi * 180 * np.arange(12 * n) / vad.SAMPLE_RATE).astype(np.float32) * .25
    silence = [np.zeros(n, np.float32)] * 8
    rng = np.random.default_rng(6)
    speech = [vad_model.synth_speech(np.random.default_rng(6 + i)) for i in range(8)]
    noise = [vad_model.synth_noise(rng) for _ in range(12)]
    for chunks, cfg in ((silence + np.split(tone, 12) + silence, dict(min_dialog_s=1.5)),
                        (silence + np.split(tone[:3 * n], 3) + silence, dict(min_dialog_s=1.5)),
                        (silence + speech + silence + noise + silence, dict(min_dialog_s=0.5))):
        got, want = _vad_segments(vad, chunks, **cfg), _vad_segments(j_vad, chunks, **cfg)
        assert [i for i, _ in got] == [i for i, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_tts_matches(tmp_path):
    from vita_tpu.serve import tts as j_tts
    from vita_tpu_torch.serve import tts

    for text in ("<1>Hello, World!</s>", 'He said «ok» — fine.', "sin(x) + cos(y)", "2^10 big",
                 "<2>"):
        assert tts.normalize_tts_text(text) == j_tts.normalize_tts_text(text)
    for text in ("hello world.", "one two three four five.", "<1></s>"):
        np.testing.assert_array_equal(tts.FormantSynthesizer().synthesize(text),
                                      j_tts.FormantSynthesizer().synthesize(text))
    a = tts.FormantSynthesizer().synthesize("test clip.")
    tts.write_wav(str(tmp_path / "a.wav"), a)
    j_tts.write_wav(str(tmp_path / "b.wav"), a)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    w, jw = tts.TTSWorker(), j_tts.TTSWorker()
    try:
        for worker in (w, jw):
            worker.submit(1, "first sentence.")
            worker.submit(2, "second one.")
            worker.drain()
        # drain() returns once the input queue is empty, while the worker
        # may still be synthesizing the last sentence: take the three
        # chunks ("first", the 0.2 s pause, "second") as they arrive
        got = [w.outputs.get(timeout=30) for _ in range(3)]
        want = [jw.outputs.get(timeout=30) for _ in range(3)]
        assert w.outputs.empty() and jw.outputs.empty()
        assert [(c.llm_id, c.text) for c in got] == [(c.llm_id, c.text) for c in want]
        for c, jc in zip(got, want):
            np.testing.assert_array_equal(c.audio, jc.audio)
    finally:
        w.stop()
        jw.stop()


def test_camera_matches():
    from vita_tpu.serve import camera as j_cam
    from vita_tpu_torch.serve import camera

    frames = camera.synthetic_camera_frames(12, 24)
    _assert_same(frames, j_cam.synthetic_camera_frames(12, 24))
    for n, fusion in ((12, "patch"), (6, "framecat"), (1, "framecat"), (0, "patch")):
        cam, jcam = camera.CameraBuffer(max_frames=8), j_cam.CameraBuffer(max_frames=8)
        for f in frames[:n]:
            cam.push(f)
            jcam.push(f)
        _assert_same(cam.snapshot_tiles(fusion), jcam.snapshot_tiles(fusion), f"{n} {fusion}")
    with pytest.raises(ValueError, match="uint8"):
        camera.CameraBuffer().push(np.zeros((8, 8, 3), np.float32))


def test_data_tools_match(tmp_path, capsys):
    """Every command of the curation CLI on the same files: the same exit
    codes, printed reports and written JSON."""
    from PIL import Image

    from vita_tpu.data import tools as j_tools
    from vita_tpu_torch.data import tools

    img = tmp_path / "ok.png"
    Image.fromarray(np.zeros((8, 130, 3), np.uint8)).save(img)
    wav = _wav(tmp_path / "a.wav", 0.5, 3)
    data = [
        {"conversations": [{"from": "human", "value": "<image>\nhi"},
                           {"from": "gpt", "value": "ok"}], "image": str(img)},
        {"conversations": [{"from": "human", "value": "<image>\nhi"},
                           {"from": "gpt", "value": "ok"}], "image": str(tmp_path / "no.png")},
        {"conversations": [{"from": "user", "value": "hi"},
                           {"from": "assistant", "value": "yo"}]},
        {"conversations": [{"from": "human", "value": "  "}, {"from": "human", "value": "a"},
                           {"from": "gpt", "value": "b"}]},
        {"conversations": [{"from": "gpt", "value": "starts wrong"}]},
        {"conversations": [{"from": "human", "value": "<audio>"},
                           {"from": "gpt", "value": "ok"}], "audio": wav},
    ]
    src = tmp_path / "in.json"
    src.write_text(json.dumps(data))
    commands = [["check-json"], ["check-media", "--check-ratio"],
                ["token-stats", "--max-length", "64"],
                ["data-stats"], ["remove-lost", "--output", "{out}"],
                ["fix-json", "--output", "{out}"], ["concat", "--output", "{out}"]]
    for cmd in commands:
        results = []
        for i, main in enumerate((tools.main, j_tools.main)):
            out = tmp_path / f"out{i}.json"
            args = [cmd[0], str(src)] + [a.format(out=out) for a in cmd[1:]]
            try:
                rc = main(args)
            except SystemExit as e:
                rc = ("exit", e.code)
            printed = capsys.readouterr()
            results.append((rc, printed.out.replace(str(out), "OUT"),
                            out.read_text() if out.exists() else None))
        assert results[0] == results[1], cmd


def test_profiling_matches_the_jax_report(tmp_path):
    """PhaseTimer on the CPU (host clock) reports what JAX's does for the
    same phases; trace() writes a torch.profiler Chrome trace."""
    import jax.numpy as jnp
    import torch

    from vita_tpu.utils import profiling as j_prof
    from vita_tpu_torch.utils import profiling

    reports = []
    for mod, arr in ((profiling, torch.ones(4)), (j_prof, jnp.ones(4))):
        timer = mod.PhaseTimer()
        for _ in range(2):
            with timer.phase("prefill", result=arr):
                pass
        with timer.phase("decode") as box:
            box["sync"] = {"x": [arr]}
        timer.dump(str(tmp_path / "r.json"))
        reports.append(json.loads((tmp_path / "r.json").read_text()))
    assert {k: (sorted(v), v["count"]) for k, v in reports[0].items()} == \
        {k: (sorted(v), v["count"]) for k, v in reports[1].items()}
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert (tmp_path / "trace" / "trace.json").exists() and len(prof.key_averages()) > 0


# --------------------------------------------------------------------------
# the native fbank: native/fbank.cc and its ctypes loader, copied
# --------------------------------------------------------------------------
def test_native_fbank_source_is_byte_equal():
    assert (ROOT / "vita_tpu_torch/native/fbank.cc").read_bytes() == \
        (ROOT / "native/fbank.cc").read_bytes()


def test_native_loader_equals_the_original_but_for_its_paths():
    """The loader's code is the original's with the package name written
    as vita_tpu, except the lines that place the source and the library
    (the copy beside the loader, the library under build/native/)."""
    from vita_tpu_torch import native

    path_lines = ("_SRC = ", "_LIB = ", "os.makedirs(os.path.dirname(_LIB)")
    keep = lambda code: [ln for ln in code.splitlines()
                         if not ln.strip().startswith(path_lines)]
    got = _code(ROOT / "vita_tpu_torch/native/__init__.py", "vita_tpu_torch")
    assert keep(got) == keep(_code(ROOT / "vita_tpu/native/__init__.py", "vita_tpu"))
    assert native._SRC == str(ROOT / "vita_tpu_torch/native/fbank.cc")
    assert native._LIB == str(ROOT / "build/native/libvitafbank.so")


def test_native_fbank_matches_numpy():
    """The port's fbank_native (the copied C++ through the copied loader)
    against the port's numpy fbank at the JAX test's tolerance 1e-4, and
    fbank_best takes it."""
    from vita_tpu_torch.native import fbank_best, fbank_native, native_available

    if not native_available():
        pytest.skip("g++ build unavailable")
    wav = (np.random.RandomState(0).randn(16000) * 0.1).astype(np.float32)
    a, b = audio.fbank(wav), fbank_native(wav)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert np.array_equal(fbank_best(wav), b)
    assert (ROOT / "build/native/libvitafbank.so").exists()
