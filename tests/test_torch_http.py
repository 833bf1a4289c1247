"""PyTorch port: the HTTP serving app (serve/http_server.py) and the
browser duplex app (serve/duplex_http.py) against the JAX package's.

ServingApp and its handler run beside JAX's over Engines with the same
tiny weights (the JAX side keeps attn_backend='xla', the flash kernel's
exact twin on the CPU), on the cases of tests/test_history.py: the built
requests must be equal field by field, the token streams identical, and
the HTTP responses the same JSON and the same SSE events, apart from the
timing fields (id, created). A session's second /v1/generate turn must
reuse its KV prefix on both. DuplexWebApp runs the cases of
tests/test_duplex_http.py."""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
from PIL import Image

from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu.serve import http_server as j_http
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.serve import duplex_http, engine, http_server
from vita_tpu_torch.serve.vad import CHUNK_SAMPLES, SAMPLE_RATE


def _enc(s):
    return [1] + [3 + b for b in s.encode()]


def _dec(ids):
    return bytes(t - 3 for t in ids if 3 <= t < 259).decode(errors="ignore")


@pytest.fixture(scope="module")
def apps():
    """(JAX app, port app, JAX base url, port base url), each app over its
    own Engine thread and HTTP server on an ephemeral port."""
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    tp = from_jax_params(jax.device_get(jp), tcfg)
    out, servers = [], []
    for mod, emod, params, cfg in ((j_http, j_engine, jp, jcfg), (http_server, engine, tp, tcfg)):
        eng = emod.Engine(params, cfg, n_slots=1, max_len=4096, decode_chunk_len=2,
                          decode_moe_mode="gather")
        app = mod.ServingApp(eng, cfg, _enc, _dec, bos_id=1, eos_id=2,
                             image_size=cfg.vision.image_size)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(app))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        out.append(app)
    yield (*out, *[f"http://127.0.0.1:{s.server_address[1]}" for s in servers])
    for srv, app in zip(servers, out):
        srv.shutdown()
        app.thread.stop()
        app.thread.join(timeout=30)


def _same_request(a, b):
    np.testing.assert_array_equal(np.asarray(a.input_ids), np.asarray(b.input_ids))
    for name in ("image_mask", "audio_mask", "images"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
    sx, sy = a.speech, b.speech
    assert (sx is None) == (sy is None)
    if sx is not None:
        for u, v in zip(sx if isinstance(sx, list) else [sx], sy if isinstance(sy, list) else [sy]):
            np.testing.assert_array_equal(u, v)
    for name in ("speech_length", "max_new_tokens", "temperature", "top_k", "top_p", "eos_id",
                 "session_key"):
        assert getattr(a, name) == getattr(b, name), name


def _run(app, req, timeout=120):
    done = threading.Event()
    req.on_finish = lambda toks, reason: done.set()
    app.engine.submit(req)
    assert done.wait(timeout)
    return req.tokens


def _png_b64(value, size=32):
    buf = io.BytesIO()
    Image.fromarray(np.full((size, size, 3), value, np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_serving_app_session_replays_image(apps):
    """An image of turn 1 is fused again in turn 3 (replay mode); equal
    requests each turn and equal tokens for turn 3."""
    japp, tapp, _, _ = apps
    img = _png_b64(128)
    turns = [({"prompt": "what is this?", "image_b64": img, "session_id": "r"}, "<3>a grey square"),
             ({"prompt": "sure?", "session_id": "r"}, "<3>yes"),
             ({"prompt": "describe it again", "session_id": "r"}, None)]
    for payload, answer in turns:
        (jr, jrec, jrel), (tr, trec, trel) = (app.build_request(payload) for app in (japp, tapp))
        _same_request(tr, jr)
        if answer is not None:
            jrec(answer)
            trec(answer)
        else:
            assert tr.images is not None and tr.images.shape[0] == 1
            text = _dec([int(t) for t in tr.input_ids])
            assert "a grey square" in text and "yes" in text
            assert _run(tapp, tr) == _run(japp, jr) and len(tr.tokens) > 0
        jrel()
        trel()


def test_serving_app_video_request(apps, tmp_path):
    """video_b64 goes through the video pipeline (1 fps frames) on both;
    image and video together is a client error."""
    import cv2

    japp, tapp, _, _ = apps
    sz = tapp.cfg.vision.image_size
    path = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (sz, sz))
    for i in range(50):
        w.write(np.full((sz, sz, 3), (i * 5) % 255, np.uint8))
    w.release()
    vid = base64.b64encode(open(path, "rb").read()).decode()
    (jr, _, jrel), (tr, _, trel) = (app.build_request({"prompt": "what happens?",
                                                        "video_b64": vid})
                                    for app in (japp, tapp))
    jrel()
    trel()
    _same_request(tr, jr)
    assert tr.images.shape[0] >= 4
    assert int(np.sum(tr.image_mask)) == tr.images.shape[0] * tapp.cfg.vision.out_tokens
    assert _run(tapp, tr) == _run(japp, jr)
    for app in (japp, tapp):
        with pytest.raises(ValueError, match="mutually exclusive"):
            app.build_request({"prompt": "x", "video_b64": vid, "image_b64": _png_b64(0, 8)})


def test_openai_chat_completions_request(apps):
    japp, tapp, _, _ = apps
    url = "data:image/png;base64," + _png_b64(90)
    body = {"messages": [
        {"role": "user", "content": "hello"},
        {"role": "assistant", "content": "hi there"},
        {"role": "user", "content": [{"type": "text", "text": "what is in this picture?"},
                                     {"type": "image_url", "image_url": {"url": url}}]},
    ], "max_tokens": 6}
    jr, tr = japp.build_openai_request(body), tapp.build_openai_request(body)
    _same_request(tr, jr)
    assert int(np.sum(tr.image_mask)) == tapp.cfg.vision.out_tokens
    assert _run(tapp, tr) == _run(japp, jr) and len(tr.tokens) == 6
    for app in (japp, tapp):
        with pytest.raises(ValueError, match="final user message"):
            app.build_openai_request({"messages": [
                {"role": "user", "content": [{"type": "image_url", "image_url": {"url": url}}]},
                {"role": "assistant", "content": "x"}, {"role": "user", "content": "y"}]})
        with pytest.raises(ValueError, match="end with a user"):
            app.build_openai_request({"messages": [{"role": "assistant", "content": "x"}]})


def test_openai_input_audio_request(apps):
    """A wav input_audio part becomes the turn's speech on both."""
    import wave

    japp, tapp, _, _ = apps
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SAMPLE_RATE)
        f.writeframes((np.random.default_rng(0).standard_normal(8000) * 3000)
                      .astype(np.int16).tobytes())
    body = {"messages": [{"role": "user", "content": [
        {"type": "input_audio", "input_audio": {"data": base64.b64encode(buf.getvalue())
                                                .decode(), "format": "wav"}}]}],
        "max_tokens": 4}
    jr, tr = japp.build_openai_request(body), tapp.build_openai_request(body)
    _same_request(tr, jr)
    assert tr.speech is not None and tr.audio_mask.any()
    assert _run(tapp, tr) == _run(japp, jr)


def _post(base, path, body):
    return urllib.request.urlopen(urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=300)


def _untimed(obj):
    return {k: v for k, v in obj.items() if k not in ("id", "created")}


def _sse(resp):
    events = [e for e in resp.read().decode().split("\n\n") if e.startswith("data: ")]
    return [e if e == "data: [DONE]" else _untimed(json.loads(e[6:])) for e in events]


def test_openai_chat_completions_http_stream(apps):
    _, _, jbase, tbase = apps
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}
    jout, tout = (json.loads(_post(b, "/v1/chat/completions", body).read())
                  for b in (jbase, tbase))
    assert _untimed(tout) == _untimed(jout)
    assert tout["object"] == "chat.completion" and tout["usage"]["completion_tokens"] == 4
    assert tout["choices"][0]["finish_reason"] == "length"
    responses = [_post(b, "/v1/chat/completions", {**body, "stream": True}) for b in (jbase, tbase)]
    assert responses[1].headers.get("Content-Type") == "text/event-stream"
    jev, tev = (_sse(r) for r in responses)
    assert tev == jev and tev[-1] == "data: [DONE]"
    assert tev[0]["choices"][0]["delta"].get("role") == "assistant"
    assert tev[-2]["choices"][0]["finish_reason"] == "length"


def test_openai_stop_sequences(apps):
    """``stop`` truncates at the earliest stop sequence on both, streamed
    or not, with finish_reason stop."""
    japp, tapp, jbase, tbase = apps
    printable = lambda ids: "".join(chr(33 + (t % 90)) for t in ids)
    japp.decode = tapp.decode = printable
    try:
        base = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 24}
        full = json.loads(_post(tbase, "/v1/chat/completions", base).read())
        full = full["choices"][0]["message"]["content"]
        stop = full[4:7]
        jout, tout = (json.loads(_post(b, "/v1/chat/completions", {**base, "stop": stop}).read())
                      for b in (jbase, tbase))
        assert _untimed(tout) == _untimed(jout)
        assert tout["choices"][0]["finish_reason"] == "stop"
        assert tout["choices"][0]["message"]["content"] == full[:full.find(stop)]
        jev, tev = (_sse(_post(b, "/v1/chat/completions",
                               {**base, "stop": [stop], "stream": True})) for b in (jbase, tbase))
        assert tev == jev
        assert "".join(e["choices"][0]["delta"].get("content", "") for e in tev[:-1]) == \
            full[:full.find(stop)]
    finally:
        japp.decode = tapp.decode = _dec


def test_generate_session_turns_reuse_the_prefix(apps):
    """Two /v1/generate turns of one session_id: the same chunked bodies
    on both servers, and the second turn reuses the first's KV prefix
    (reused_prefix_rows in /stats grows, by the same rows on both)."""
    japp, tapp, jbase, tbase = apps
    before = [json.loads(urllib.request.urlopen(b + "/stats", timeout=30).read())
              for b in (jbase, tbase)]
    bodies = []
    for prompt in ("tell me a story", "and then?"):
        payload = {"prompt": prompt, "session_id": "g", "max_tokens": 6}
        bodies.append([_post(b, "/v1/generate", payload).read() for b in (jbase, tbase)])
    assert all(j == t for j, t in bodies)
    after = [json.loads(urllib.request.urlopen(b + "/stats", timeout=30).read())
             for b in (jbase, tbase)]
    grown = [a["reused_prefix_rows"] - b["reused_prefix_rows"] for a, b in zip(after, before)]
    assert grown[1] == grown[0] > 0
    health = json.loads(urllib.request.urlopen(tbase + "/health", timeout=30).read())
    assert health == {"status": "ok", "active": 0}
    for b in (jbase, tbase):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(b, "/v1/generate", {"prompt": "x" * 5000})
        assert err.value.code == 400


def _duplex_app(**kw):
    import torch

    from vita_tpu_torch.cli import ByteTokenizer

    cfg = vita.VITAConfig.tiny()
    params = vita.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = ByteTokenizer()
    kw.setdefault("max_new_tokens", 24)
    return duplex_http.DuplexWebApp(params, cfg, tok.encode, tok.decode, tok.bos_id, -1, **kw)


def test_duplex_over_http_end_to_end():
    """The recorded synthetic session POSTed as int16 chunks: VAD events,
    two utterances, streamed text, an interrupt and TTS wavs reach the
    event stream; the page and /stats serve."""
    from vita_tpu_torch.serve.duplex_demo import synth_session

    app = _duplex_app()
    server = ThreadingHTTPServer(("127.0.0.1", 0), duplex_http.make_handler(app))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    events, stop = [], threading.Event()

    def sse_reader():
        resp = urllib.request.urlopen(base + "/events", timeout=60)
        while not stop.is_set():
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))

    threading.Thread(target=sse_reader, daemon=True).start()
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "getUserMedia" in page and "/audio" in page and "EventSource" in page
        jpg = io.BytesIO()
        Image.fromarray(np.zeros((120, 160, 3), np.uint8) + 64).save(jpg, format="JPEG")
        r = urllib.request.urlopen(urllib.request.Request(base + "/camera", data=jpg.getvalue(),
                                                          method="POST"), timeout=10)
        assert json.loads(r.read())["frames"] == 1
        pcm = (np.clip(np.concatenate(synth_session()), -1, 1) * 32767).astype("<i2")
        for i in range(0, len(pcm), CHUNK_SAMPLES):
            urllib.request.urlopen(urllib.request.Request(
                base + "/audio", data=pcm[i:i + CHUNK_SAMPLES].tobytes(), method="POST"),
                timeout=30)
            if app.n_utterances == 1:
                time.sleep(0.02)  # let the first answer stream before the second query
        assert app.drain_audio(timeout=120)
        t0 = time.time()
        while time.time() - t0 < 120:
            if app.n_utterances >= 2 and {"interrupt", "tts"} <= {e["type"] for e in events}:
                break
            time.sleep(0.1)
        st = json.loads(urllib.request.urlopen(base + "/stats", timeout=30).read())
        assert st["utterances"] == app.n_utterances == 2
    finally:
        stop.set()
        server.shutdown()
        app.close()
    kinds = [e["type"] for e in events]
    assert {"vad", "utterance", "text", "interrupt"} <= set(kinds)
    tts = [e for e in events if e["type"] == "tts"]
    assert tts and all(e["wav_b64"] for e in tts)
    wav = base64.b64decode(tts[0]["wav_b64"])
    assert wav[:4] == b"RIFF" and len(wav) > 1000


def test_feed_pcm_chunking_and_events():
    """Odd-sized PCM pushes re-chunk to the VAD frame; VAD start/end and
    one utterance (whole-utterance encode) reach the subscribers."""
    from vita_tpu_torch.serve.vad_model import synth_speech

    app = _duplex_app(tts=False, warm=False, streaming_encode=False)
    q = app.subscribe()
    try:
        rng = np.random.default_rng(3)
        speech = np.concatenate([synth_speech(rng, CHUNK_SAMPLES) for _ in range(14)])
        silence = np.zeros(int(2.0 * SAMPLE_RATE), np.float32)
        stream = np.concatenate([silence, speech, silence])
        for i in range(0, len(stream), 1234):
            app.feed_pcm(stream[i:i + 1234])
        assert app.drain_audio(timeout=120)
        t0 = time.time()
        while app.n_utterances == 0 and time.time() - t0 < 60:
            time.sleep(0.05)
        assert app.n_utterances == 1
        kinds = []
        while not q.empty():
            kinds.append(q.get()["type"])
        assert "vad" in kinds and "utterance" in kinds
    finally:
        app.unsubscribe(q)
        app.close()
