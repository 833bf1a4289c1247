"""PyTorch port: the three serving entry points as a user starts them.

(1) ServingApp(history_mode="interactive") of both packages over the same
tiny weights: two turns of one session, each with its own image, the
second with audio too. The built requests are equal and the greedy
streams identical; the second turn carries only its own image, at the
front, where a replay-mode app carries both.
(2) ``python -m vita_tpu_torch.serve.http_server --history-mode
interactive`` as a child process: /health, two turns of one session
(audio, then text), SIGINT -> exit 0; its bodies equal those of an
in-process ServingApp over an Engine built with main's arguments.
(3) ``python -m vita_tpu_torch.serve.duplex_http`` as a child process:
the synthetic mic session POSTed to /audio, /stats shows 2 utterances,
SIGINT -> exit 0.
(4) duplex_demo.main of both packages with the synthetic camera, TTS and
a history of one turn: both exit 0 and write wavs, and their Engines
accept the same requests by layout (image tokens, audio spans, image
before audio)."""

import base64
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
import torch_port_util  # noqa: F401  (pins torch threads)
from test_torch_http import _dec, _enc, _png_b64, _run, _same_request

from vita_tpu.models import vita as j_vita
from vita_tpu.serve import engine as j_engine
from vita_tpu.serve import http_server as j_http
from vita_tpu_torch.convert import from_jax_params
from vita_tpu_torch.models import vita
from vita_tpu_torch.serve import engine, http_server
from vita_tpu_torch.serve.vad import CHUNK_SAMPLES, SAMPLE_RATE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pcm_b64(seconds=1.0, seed=5):
    from vita_tpu_torch.serve.vad_model import synth_speech

    rng = np.random.default_rng(seed)
    n = int(seconds * SAMPLE_RATE)
    wav = np.concatenate([synth_speech(rng, CHUNK_SAMPLES)
                          for _ in range(n // CHUNK_SAMPLES + 1)])[:n]
    return base64.b64encode((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()).decode()


def _spans(mask):
    """(start, length) of each run of True in ``mask``."""
    if mask is None:
        return []
    m = np.asarray(mask, bool).astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], m, [0]])))
    return [(int(a), int(b - a)) for a, b in zip(edges[::2], edges[1::2])]


def _layout(req):
    """(image positions, audio spans, whether every image position lies
    before the first audio position) of an accepted request."""
    im, am = _spans(req.image_mask), _spans(req.audio_mask)
    n_img = sum(n for _, n in im)
    first_audio = am[0][0] if am else len(req.input_ids)
    last_image = im[-1][0] + im[-1][1] - 1 if im else -1
    return n_img, len(am), last_image < first_audio


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(base, path, timeout=30):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return json.loads(r.read())


def _post(base, path, body, timeout=300):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _wait_up(proc, base, path, timeout=180):
    """Polls ``path`` until the child's server answers; fails if the
    child exits first."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode} before serving")
        try:
            return _get(base, path, timeout=5)
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"no answer on {path} in {timeout} s")


def _interrupt(proc, timeout=60):
    proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise


def _child(module, *args):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def interactive_apps():
    """(JAX interactive app, port interactive app, port replay app), each
    over its own Engine thread on the same tiny weights."""
    jcfg = j_vita.VITAConfig.tiny()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, attn_backend="xla"))
    jp = j_vita.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = vita.VITAConfig.tiny()
    tp = from_jax_params(jax.device_get(jp), tcfg)
    apps = []
    for mod, emod, params, cfg, mode in ((j_http, j_engine, jp, jcfg, "interactive"),
                                         (http_server, engine, tp, tcfg, "interactive"),
                                         (http_server, engine, tp, tcfg, "replay")):
        eng = emod.Engine(params, cfg, n_slots=1, max_len=4096, decode_chunk_len=2,
                          decode_moe_mode="gather")
        apps.append(mod.ServingApp(eng, cfg, _enc, _dec, bos_id=1, eos_id=2,
                                   image_size=cfg.vision.image_size, history_mode=mode))
    yield apps
    for app in apps:
        app.thread.stop()
        app.thread.join(timeout=30)


def test_interactive_serving_app_against_jax(interactive_apps):
    """Two turns of one session, each with its own image (the second with
    audio too): equal requests and identical streams in both packages;
    the second turn carries its own image alone, ahead of the history's
    audio and text, where replay carries both images."""
    japp, tapp, replay = interactive_apps
    imgs = (_png_b64(60), _png_b64(200))
    turns = [{"prompt": "what is this?", "image_b64": imgs[0], "session_id": "i",
              "max_tokens": 6},
             {"prompt": "and this?", "image_b64": imgs[1], "audio_b64": _pcm_b64(),
              "session_id": "i", "max_tokens": 6}]
    for k, payload in enumerate(turns):
        (jr, jrec, jrel), (tr, trec, trel), (rr, rrec, rrel) = (
            app.build_request(payload) for app in (japp, tapp, replay))
        try:
            _same_request(tr, jr)
            got, want = _run(tapp, tr), _run(japp, jr)
            assert got == want and len(got) > 0
            # the handler records the decoded stream as the turn's response
            for rec in (jrec, trec, rrec):
                rec(_dec(got).replace("</s>", ""))
        finally:
            jrel()
            trel()
            rrel()
        if k == 1:
            ids = [int(t) for t in tr.input_ids]
            own = replay._decode_media({"image_b64": imgs[1]})[1]
            assert tr.images.shape[0] == 1
            np.testing.assert_array_equal(np.asarray(tr.images), np.asarray(own))
            # fronted: the one image span opens the first user message,
            # ahead of the history's text and of the audio
            (im0, _), = _spans(tr.image_mask)
            assert len(_spans(tr.audio_mask)) == 1 and _layout(tr)[2]
            assert "what is this?" not in _dec(ids[:im0]) and "what is this?" in _dec(ids[im0:])
            # replay keeps turn 1's image and puts turn 2's after the history
            spans = _spans(rr.image_mask)
            assert rr.images.shape[0] == 2 and len(spans) == 2
            assert "what is this?" in _dec([int(t) for t in rr.input_ids[:spans[1][0]]])


def test_http_server_main_interactive_in_a_child_process():
    """The server's main in a child process on the CPU: /health, an audio
    turn and a text turn of one session (the second reusing the first's
    prefix), then SIGINT: exit code 0. The bodies equal those of an
    in-process ServingApp over main's Engine on the same weights."""
    from vita_tpu_torch.cli import ByteTokenizer

    port = _free_port()
    proc = _child("vita_tpu_torch.serve.http_server", "--model", "tiny-random", "--device", "cpu",
                  "--history-mode", "interactive", "--port", str(port))
    child = f"http://127.0.0.1:{port}"
    turns = [{"audio_b64": _pcm_b64(), "session_id": "c", "max_tokens": 8},
             {"prompt": "tell me more", "session_id": "c", "max_tokens": 8}]
    try:
        assert _wait_up(proc, child, "/health") == {"status": "ok", "active": 0}
        got = [_post(child, "/v1/generate", t) for t in turns]
        got_rows = _get(child, "/stats")["reused_prefix_rows"]
        rc = _interrupt(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = proc.stdout.read().decode()
    assert rc == 0, out
    assert "[serve] listening" in out

    cfg = vita.VITAConfig.tiny()
    params = vita.init_params(cfg, torch.Generator().manual_seed(0))
    eng = engine.Engine(params, cfg, n_slots=4, max_len=4096, decode_ticks=4, kv_int8=False,
                        page_size=64, mesh=None, sharded=False, device=torch.device("cpu"))
    tok = ByteTokenizer()
    app = http_server.ServingApp(eng, cfg, tok.encode, tok.decode, tok.bos_id, tok.eos_id,
                                 image_size=cfg.vision.image_size, history_mode="interactive")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), http_server.make_handler(app))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ref = f"http://127.0.0.1:{srv.server_address[1]}"
        want = [_post(ref, "/v1/generate", t) for t in turns]
        want_rows = _get(ref, "/stats")["reused_prefix_rows"]
    finally:
        srv.shutdown()
        app.thread.stop()
        app.thread.join(timeout=30)
    assert got == want
    assert got_rows == want_rows > 0


def test_duplex_http_main_in_a_child_process():
    """duplex_http's main in a child process on the CPU: the synthetic mic
    session POSTed as int16 chunks to /audio gives 2 utterances (the noise
    between them is no utterance) in /stats; SIGINT: exit code 0."""
    from vita_tpu_torch.serve.duplex_demo import synth_session

    port = _free_port()
    proc = _child("vita_tpu_torch.serve.duplex_http", "--device", "cpu", "--port", str(port),
                  "--max-new-tokens", "8")
    base = f"http://127.0.0.1:{port}"
    try:
        assert _wait_up(proc, base, "/stats")["utterances"] == 0
        pcm = (np.clip(np.concatenate(synth_session()), -1, 1) * 32767).astype("<i2")
        for i in range(0, len(pcm), CHUNK_SAMPLES):
            req = urllib.request.Request(base + "/audio", data=pcm[i:i + CHUNK_SAMPLES].tobytes(),
                                         method="POST")
            urllib.request.urlopen(req, timeout=60).read()
        deadline = time.time() + 120
        while _get(base, "/stats")["utterances"] < 2 and time.time() < deadline:
            time.sleep(0.1)
        stats = _get(base, "/stats")
        rc = _interrupt(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = proc.stdout.read().decode()
    assert stats["utterances"] == 2, (stats, out)
    assert rc == 0, out


def _recording_submit(cls, store):
    real = cls.submit

    def submit(self, req):
        store.append(req)
        return real(self, req)

    return real, submit


DEMO_FLAGS = ["--simulate", "--camera", "synthetic", "--history-limit", "1", "--tts-pace", "0",
              "--settle-s", "2", "--max-new-tokens", "8"]


def test_duplex_demo_camera_tts_history_against_jax(tmp_path, monkeypatch, capsys):
    """duplex_demo.main of both packages with the synthetic camera, TTS
    wavs and a history of one turn: exit 0, wavs written, and the same
    requests accepted by layout: 2 warm-up queries and 2 utterances, each
    with the 8 camera frames' image tokens before its audio, the second
    utterance with the history's audio span beside its own and no
    history image."""
    from vita_tpu.serve import duplex_demo as j_demo
    from vita_tpu_torch.serve import duplex_demo

    runs = {}
    for name, demo, emod, extra in (("port", duplex_demo, engine, ["--device", "cpu"]),
                                    ("jax", j_demo, j_engine, [])):
        store, tts = [], tmp_path / name
        real, spy = _recording_submit(emod.Engine, store)
        monkeypatch.setattr(emod.Engine, "submit", spy)
        try:
            rc = demo.main(DEMO_FLAGS + ["--tts-dir", str(tts)] + extra)
        finally:
            monkeypatch.setattr(emod.Engine, "submit", real)
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "[demo] done: 2 queries" in out
        wavs = sorted(tts.glob("*.wav"))
        assert wavs and all(w.stat().st_size > 44 for w in wavs), out
        runs[name] = [_layout(r) for r in store]
    n_img = 8 * vita.VITAConfig.tiny().image_tokens_per_group
    assert runs["port"] == runs["jax"]
    # two warm-up queries (one an Engine), then the two utterances
    assert runs["port"] == [(n_img, 1, True)] * 3 + [(n_img, 2, True)]
