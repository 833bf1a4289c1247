"""Browser-based interactive duplex demo: live microphone -> VAD -> duplex
engines -> streamed text + autoplayed TTS, with optional webcam context.

vita_tpu.serve.duplex_http over the port's Engine: the live mic/webcam
loop of the reference's interactive web demo over the stdlib HTTP server:

- GET  /            the page: JS getUserMedia mic capture, downsampled to
                    16 kHz int16 PCM, POSTed in ~250 ms chunks; an
                    EventSource renders streamed text, role-swap/interrupt
                    badges, and autoplays TTS wavs; optional webcam JPEG
                    frames POST at ~2 fps into the camera ring buffer.
- POST /audio       raw little-endian int16 PCM @16 kHz (any chunk size)
- POST /camera      one JPEG frame (webcam context, ref :706-720)
- GET  /events      Server-Sent Events: vad / utterance / text / sentence /
                    tts (base64 wav) / turn / interrupt / reject / stats
- GET  /stats       controller + engine counters as JSON

Run: ``python -m vita_tpu_torch.serve.duplex_http --model tiny-random``
(on the card; ``--device cpu`` runs on the CPU) then open
http://127.0.0.1:8820/ and talk. The two Engines share one weights dict
on one device. ``--mesh EXPERT MODEL`` deploys them as two replicas over
disjoint ranks of a torchrun launch of 2*EXPERT*MODEL ranks
(``torchrun --nproc-per-node N -m vita_tpu_torch.serve.duplex_http
--model M --mesh E M2``; ``--dist-backend gloo`` when the ranks share one
card): each replica an expert x model mesh stepping on its own, rank 0
serving the page and driving both through the controller (replica 1
through serve.replicas.RemoteReplica).

The whole backend (VAD hysteresis, streaming Whale encode during speech,
'<2>' noise gating, generator/monitor role swap, sentence-chunked formant
TTS, camera tiles) is the same stack `duplex_demo.py` drives from the CLI;
this module only adds the browser transport. Driven end-to-end by
tests/test_duplex_http.py (recorded PCM chunks over HTTP -> events)."""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional

import numpy as np
import torch

from vita_tpu_torch.serve.camera import CameraBuffer
from vita_tpu_torch.serve.duplex import DuplexConfig, DuplexController
from vita_tpu_torch.serve.engine import Engine, EngineThread, Request
from vita_tpu_torch.serve.history import ChatSession, HistoryTurn
from vita_tpu_torch.serve.vad import CHUNK_SAMPLES, SAMPLE_RATE, StreamingVAD, VADConfig
from vita_tpu_torch.tokenization import (
    audio_token_count,
    expand_media_sentinels,
    media_masks,
    tokenize_multimodal,
)


def _wav_bytes(samples: np.ndarray, sample_rate: int = SAMPLE_RATE) -> bytes:
    """In-memory 16-bit PCM wav (the browser autoplays it as a data URL)."""
    import struct

    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16,
        1, 1, sample_rate, sample_rate * 2, 2, 16, b"data", len(pcm),
    )
    return hdr + pcm


class DuplexWebApp:
    """Backend state for the browser duplex demo: two engines + controller
    + streaming VAD/encoder + camera ring + TTS, with a broadcast event
    queue the SSE endpoint drains."""

    def __init__(
        self,
        params: Any,
        cfg: Any,
        encode,
        decode,
        bos_id: int,
        eos_id: int,
        max_new_tokens: int = 48,
        max_len: int = 1024,
        history_limit: int = 5,
        streaming_encode: bool = True,
        tts: bool = True,
        warm: bool = True,
        engines: Optional[list] = None,
    ):
        """``engines``: two started engine loops to drive instead of two
        Engines built here (the replicas of ``--mesh``: rank 0's
        MeshEngineThread and RemoteReplica)."""
        self.cfg = cfg
        self.encode = encode
        self.decode = decode
        self.bos_id = bos_id
        # decode_ticks=1: duplex interactivity needs per-chunk streaming —
        # TTS pacing and barge-in (cancel_all) latency degrade when tokens
        # arrive in bursts of decode_ticks*chunk_len (see engine.py multi-tick
        # dispatch note).
        if engines is None:
            self.engines = [
                Engine(params, cfg, n_slots=2, max_len=max_len, seed=i, decode_ticks=1)
                for i in range(2)
            ]
            self._threads = [EngineThread(e) for e in self.engines]
        else:
            self.engines = self._threads = list(engines)
        self.session = ChatSession(limit=history_limit)
        self._turn_meta = {}
        self.camera = CameraBuffer(max_frames=8)
        self._synth = None
        if tts:
            from vita_tpu_torch.serve.tts import FormantSynthesizer

            self._synth = FormantSynthesizer()

        # SSE broadcast: each connected client owns a queue; events fan out
        self._clients: List[queue.Queue] = []
        self._clients_lock = threading.Lock()
        self._seq = 0

        self.ctl = DuplexController(
            self.engines, decode,
            on_text=lambda s: self._emit("text", chunk=s),
            on_tts=self._on_tts,
            on_turn=self._on_turn,
            config=DuplexConfig(max_new_tokens=max_new_tokens, eos_id=eos_id),
        )
        self._prev_generator = self.ctl.generator_idx
        self._counts = {"interrupts": 0, "rejected": 0}

        vad = StreamingVAD(VADConfig(min_dialog_s=1.5))
        self._frontend = None
        if streaming_encode:
            from vita_tpu_torch.serve.streaming_audio import StreamingAudioFrontend

            self._frontend = StreamingAudioFrontend(
                params["audio"], cfg.audio, vad=vad
            )
        self.vad = vad
        self._pcm_tail = np.zeros(0, np.float32)
        self._was_in_speech = False
        self.n_utterances = 0

        if warm:
            self._warmup()
        if engines is None:
            for t in self._threads:
                t.start()
        # audio runs on its own worker: the mic POST must return
        # immediately even while an utterance flush compiles/encodes (the
        # browser's fetch would otherwise back up and drop audio)
        self._audio_q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue()
        self._audio_thread = threading.Thread(
            target=self._audio_worker, daemon=True
        )
        self._audio_thread.start()

    # -- events ------------------------------------------------------------
    def _emit(self, type_: str, **kw) -> None:
        self._seq += 1
        evt = {"type": type_, "seq": self._seq, "t": time.time(), **kw}
        with self._clients_lock:
            for q in self._clients:
                q.put(evt)

    def subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue()
        with self._clients_lock:
            self._clients.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._clients_lock:
            if q in self._clients:
                self._clients.remove(q)

    # -- duplex hooks ------------------------------------------------------
    def _on_tts(self, sentence: str) -> None:
        self._emit("sentence", text=sentence.strip())
        if self._synth is None:
            return
        from vita_tpu_torch.serve.tts import normalize_tts_text

        speakable = normalize_tts_text(sentence)
        if not speakable:
            # random-weight demo models emit arbitrary bytes; transliterate
            # so the audio path still demonstrates end-to-end
            speakable = "".join(
                "aeioubdklmnprst"[ord(c) % 15] for c in sentence.strip()[:32]
            ) or "a"
        wav = self._synth.synthesize(speakable)
        self._emit(
            "tts", text=sentence.strip(),
            duration_s=round(len(wav) / SAMPLE_RATE, 3),
            wav_b64=base64.b64encode(_wav_bytes(wav)).decode(),
        )

    def _on_turn(self, req: Request, text: str) -> None:
        turn = self._turn_meta.pop(req.request_id, None)
        if turn is not None:
            turn.response = text
            self.session.add(turn)
        self._emit("turn", text=text,
                   engine=getattr(req, "_duplex_engine_idx", -1))

    # -- inputs ------------------------------------------------------------
    def feed_pcm(self, pcm: np.ndarray) -> None:
        """Enqueue float32 mono 16 kHz samples (any length); the audio
        worker chunks them to the VAD frame size and drives the duplex
        protocol (ref mic loop :776-865). Returns immediately."""
        self._audio_q.put(np.asarray(pcm, np.float32))

    def drain_audio(self, timeout: float = 120.0) -> bool:
        """Block until all queued audio has been processed (tests)."""
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self._audio_q.empty() and not self._audio_busy:
                return True
            time.sleep(0.02)
        return False

    _audio_busy = False

    def _audio_worker(self) -> None:
        while True:
            pcm = self._audio_q.get()
            if pcm is None:
                return
            self._audio_busy = True
            try:
                buf = np.concatenate([self._pcm_tail, pcm])
                n = len(buf) // CHUNK_SAMPLES
                self._pcm_tail = buf[n * CHUNK_SAMPLES:]
                for i in range(n):
                    self._feed_chunk(
                        buf[i * CHUNK_SAMPLES:(i + 1) * CHUNK_SAMPLES]
                    )
            except Exception:  # noqa: BLE001 — mic loop must survive
                import traceback

                traceback.print_exc()
            finally:
                self._audio_busy = False

    def _feed_chunk(self, chunk: np.ndarray) -> None:
        if self._frontend is not None:
            utt = self._frontend.process(chunk)
            seg, enc = (utt.wav, utt.features) if utt is not None else (None, None)
            in_speech = self._frontend.vad.in_speech
        else:
            seg, enc = self.vad.process(chunk), None
            in_speech = self.vad.in_speech
        if in_speech != self._was_in_speech:
            self._was_in_speech = in_speech
            self._emit("vad", state="start" if in_speech else "end")
        if seg is None:
            return
        self.n_utterances += 1
        before = self.ctl.interrupts, self.ctl.rejected_noise
        monitor = 1 - self.ctl.generator_idx
        self._emit("utterance", seconds=round(len(seg) / SAMPLE_RATE, 2),
                   engine=monitor)
        self.ctl.submit_query(self._make_query(seg, enc))
        self._watch_outcome(before)

    def _watch_outcome(self, before) -> None:
        """Emit interrupt/reject events once the gate decides (first visible
        tokens) — polled off-thread so the mic feed never blocks."""

        def poll():
            deadline = time.time() + 30.0
            while time.time() < deadline:
                i, r = self.ctl.interrupts, self.ctl.rejected_noise
                if i > before[0]:
                    self._counts["interrupts"] = i
                    self._emit("interrupt", generator=self.ctl.generator_idx)
                    return
                if r > before[1]:
                    self._counts["rejected"] = r
                    self._emit("reject")
                    return
                time.sleep(0.02)

        threading.Thread(target=poll, daemon=True).start()

    def push_camera_jpeg(self, data: bytes) -> int:
        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        sz = self.cfg.vision.image_size
        self.camera.push(np.asarray(img.resize((sz, sz))))
        return len(self.camera)

    # -- query construction (duplex_demo.make_query, shared rules) ---------
    def _camera_tiles(self) -> Optional[List[np.ndarray]]:
        if len(self.camera) == 0:
            return None
        tiles, _ = self.camera.snapshot_tiles(self.cfg.vision_fusion)
        return tiles

    def _make_query(self, segment, encoded=None) -> Request:
        from vita_tpu_torch.data.audio import fbank

        cfg = self.cfg
        images = None
        img_counts: List[int] = []
        prompt_text = "<audio>"
        frames = self._camera_tiles()
        if frames is not None:
            from vita_tpu_torch.data.image import normalize

            images = normalize(frames)
            img_counts = [(len(frames) // cfg.image_group_tiles)
                          * cfg.image_tokens_per_group]
            prompt_text = "<image>\n<audio>"
        media_common = dict(images=images,
                            image_slot_counts=tuple(img_counts),
                            skip_history_vision=True,
                            image_tokens_to_front=True)
        if encoded is not None:
            merged = self.session.merge(
                prompt_text, encoded=encoded, encoded_length=len(encoded),
                **media_common,
            )
            aud_counts = [(l - 1) // 2 + 1 for l in merged.encoded_lengths]
            media_kw = dict(audio_encoded=merged.encodeds,
                            audio_encoded_length=merged.encoded_lengths)
            turn = HistoryTurn(prompt=prompt_text, response="",
                               encoded=encoded, encoded_length=len(encoded))
        else:
            feats = fbank(segment)
            merged = self.session.merge(
                prompt_text, speech=feats, speech_length=len(feats),
                **media_common,
            )
            aud_counts = [audio_token_count(l) for l in merged.speech_lengths]
            media_kw = dict(speech=merged.speeches,
                            speech_length=merged.speech_lengths)
            turn = HistoryTurn(prompt=prompt_text, response="",
                               speech=feats, speech_length=len(feats))
        ids = tokenize_multimodal(merged.prompt, self.encode, bos_id=self.bos_id)
        expanded = expand_media_sentinels(
            ids, list(merged.image_slot_counts), aud_counts)
        safe, im, am = media_masks(np.array(expanded))
        req = self.ctl.new_request(
            input_ids=safe, audio_mask=am,
            image_mask=im if merged.images is not None else None,
            images=merged.images, **media_kw,
        )
        self._turn_meta[req.request_id] = turn
        return req

    def _warmup(self) -> None:
        """Run the audio(+camera) prefill and decode once on each engine
        before the live session (first-use costs must not eat the
        interaction): Engines stepped here before their threads start, or
        running replica loops waited on."""
        from vita_tpu_torch.serve.replicas import serve_one

        t0 = time.time()
        if self._frontend is not None:
            enc = self._frontend.encoder
            enc.feed(np.zeros((300, self.cfg.audio.input_dim), np.float32))
            feats = enc.finish()
            enc.reset()
            mk = lambda: self._make_query(None, encoded=feats)
        else:
            mk = lambda: self._make_query(
                np.zeros(int(3.0 * SAMPLE_RATE), np.float32))
        for e in self.engines:
            w = mk()
            w.max_new_tokens = 9
            serve_one(e, w)
        self.session.turns.clear()
        self._turn_meta.clear()
        self._emit("ready", warm_s=round(time.time() - t0, 1))

    def stats(self) -> dict:
        return {
            "utterances": self.n_utterances,
            "interrupts": self.ctl.interrupts,
            "rejected_noise": self.ctl.rejected_noise,
            "generator": self.ctl.generator_idx,
            "camera_frames": len(self.camera),
            "history_turns": len(self.session.turns),
            "engines": [e.stats() for e in self.engines],
        }

    def close(self) -> None:
        self._audio_q.put(None)
        for t in self._threads:
            t.stop()
        for e in self.engines:
            e.cancel_all()
        for t in self._threads:
            t.join(timeout=30)
        self._audio_thread.join(timeout=10)


PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>VITA duplex</title><style>
body{font-family:system-ui,sans-serif;max-width:760px;margin:2em auto;padding:0 1em}
#log{border:1px solid #ccc;border-radius:8px;min-height:14em;padding:1em;white-space:pre-wrap}
.badge{display:inline-block;border-radius:6px;padding:1px 8px;margin:0 2px;font-size:.8em;color:#fff}
.b-vad{background:#2a7} .b-int{background:#d33} .b-rej{background:#888} .b-utt{background:#36c}
button{font-size:1em;padding:.4em 1.2em;border-radius:8px;margin-right:.6em}
video{width:160px;border-radius:8px;display:none}
</style></head><body>
<h2>VITA interactive duplex demo</h2>
<p>Talk; the monitor model answers, speech interrupts it, background noise
is rejected (<code>&lt;2&gt;</code>). Optional webcam frames become video
context for each query.</p>
<button id="mic">Start mic</button>
<button id="cam">Start webcam</button>
<span id="state"></span>
<video id="v" autoplay muted playsinline></video>
<div id="log"></div>
<script>
const log = document.getElementById('log'), state = document.getElementById('state');
function badge(cls, txt){ const s=document.createElement('span'); s.className='badge '+cls; s.textContent=txt; log.appendChild(s); }
function text(t){ log.appendChild(document.createTextNode(t)); log.scrollTop=log.scrollHeight; }
const es = new EventSource('/events');
es.onmessage = (m) => {
  const e = JSON.parse(m.data);
  if (e.type === 'text') text(e.chunk);
  else if (e.type === 'vad') state.textContent = e.state === 'start' ? '🎤 speech…' : '';
  else if (e.type === 'utterance') { badge('b-utt', 'query '+e.seconds+'s → engine '+e.engine); text('\\n'); }
  else if (e.type === 'interrupt') badge('b-int', 'interrupt → engine '+e.generator+' speaks');
  else if (e.type === 'reject') badge('b-rej', 'noise rejected');
  else if (e.type === 'tts' && e.wav_b64) new Audio('data:audio/wav;base64,'+e.wav_b64).play().catch(()=>{});
  else if (e.type === 'turn') text('\\n');
  else if (e.type === 'ready') badge('b-vad', 'engines warm ('+e.warm_s+'s)');
};
document.getElementById('mic').onclick = async () => {
  const ctx = new AudioContext();
  const stream = await navigator.mediaDevices.getUserMedia({audio:true});
  const src = ctx.createMediaStreamSource(stream);
  const proc = ctx.createScriptProcessor(4096, 1, 1);
  const ratio = ctx.sampleRate / 16000;
  src.connect(proc); proc.connect(ctx.destination);
  let acc = [];
  proc.onaudioprocess = (ev) => {
    const inp = ev.inputBuffer.getChannelData(0);
    const out = new Int16Array(Math.floor(inp.length / ratio));
    for (let i = 0; i < out.length; i++) {
      const v = inp[Math.floor(i * ratio)];
      out[i] = Math.max(-1, Math.min(1, v)) * 32767;
    }
    acc.push(out);
    const total = acc.reduce((n, a) => n + a.length, 0);
    if (total >= 4096) {   // ~256 ms at 16 kHz
      const buf = new Int16Array(total); let o = 0;
      for (const a of acc) { buf.set(a, o); o += a.length; }
      acc = [];
      fetch('/audio', {method:'POST', body: buf.buffer});
    }
  };
  document.getElementById('mic').disabled = true;
  state.textContent = 'mic live';
};
document.getElementById('cam').onclick = async () => {
  const v = document.getElementById('v');
  v.srcObject = await navigator.mediaDevices.getUserMedia({video:{width:320}});
  v.style.display = 'inline-block';
  const c = document.createElement('canvas');
  setInterval(() => {
    if (!v.videoWidth) return;
    c.width = 224; c.height = 224;
    c.getContext('2d').drawImage(v, 0, 0, 224, 224);
    c.toBlob((b) => b && fetch('/camera', {method:'POST', body:b}), 'image/jpeg', .8);
  }, 500);
  document.getElementById('cam').disabled = true;
};
</script></body></html>
"""


def make_handler(app: DuplexWebApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/stats":
                self._send(200, json.dumps(app.stats()).encode())
            elif self.path == "/events":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q = app.subscribe()
                try:
                    while True:
                        try:
                            evt = q.get(timeout=15.0)
                            payload = f"data: {json.dumps(evt)}\n\n"
                        except queue.Empty:
                            payload = ": keepalive\n\n"
                        self.wfile.write(payload.encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    app.unsubscribe(q)
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            if self.path == "/audio":
                pcm = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
                app.feed_pcm(pcm)
                self._send(200, b'{"ok": true}')
            elif self.path == "/camera":
                try:
                    k = app.push_camera_jpeg(data)
                    self._send(200, json.dumps({"frames": k}).encode())
                except Exception as e:  # bad frame must not kill the loop
                    self._send(400, json.dumps({"error": str(e)[:200]}).encode())
            else:
                self._send(404, b'{"error": "not found"}')

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Browser duplex demo server")
    p.add_argument("--model", default="tiny-random")
    p.add_argument("--port", type=int, default=8820)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--max-new-tokens", type=int, default=48)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--no-streaming-encode", action="store_true")
    p.add_argument("--mesh", type=int, nargs=2, metavar=("EXPERT", "MODEL"),
                   default=None,
                   help="per-replica expert x model mesh: a torchrun launch of "
                        "2*EXPERT*MODEL ranks serves the two engines as two replicas "
                        "over disjoint ranks (the reference's 2x TP=2 deployment)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend under --mesh (default nccl on cards, "
                        "gloo on the CPU; ranks sharing one card need gloo)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch; pass --device cpu to run on the CPU")
    served = serve_replicas(args, device)
    if isinstance(served, int):  # a rank other than 0: its replica's loop has ended
        return served
    (cfg, params, encode, decode, bos_id, eos_id), engines = served
    app = DuplexWebApp(
        params, cfg, encode, decode, bos_id, eos_id,
        max_new_tokens=args.max_new_tokens, max_len=args.max_len,
        streaming_encode=not args.no_streaming_encode,
        warm=not args.no_warmup, engines=engines,
    )
    server = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    for e in engines or ():  # a failed replica stops the server
        e.on_error = server.shutdown
    failed = [e for e in engines or () if e.error is not None]
    print(f"[duplex] open http://{args.host}:{args.port}/ and talk")
    try:
        if not failed:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.close()
    failed = [e.error for e in engines or () if e.error is not None]
    if failed:
        print(f"[duplex] a serving replica failed: {failed[0]!r}", file=sys.stderr)
        return 1
    return 0


def serve_replicas(args, device: torch.device, eos: bool = False):
    """The model and the two engines of the duplex surfaces. Without
    ``args.mesh``: (load_model's tuple, None), the caller builds two
    Engines. Under ``--mesh E M``: this rank's shards and Engine of its
    replica (parallel.distributed.serving_replicas); rank 0 gets
    (load_model's tuple, [replica 0's loop, replica 1's RemoteReplica],
    both started); any other rank runs its replica's loop here and gets
    its exit code: 0 when rank 0 stopped the replicas, 1 when they failed."""
    from vita_tpu_torch.serve.http_server import load_model

    if args.mesh is None:
        return load_model(args.model, device, eos=eos), None
    import torch.distributed as dist

    from vita_tpu_torch.parallel import distributed
    from vita_tpu_torch.serve.replicas import replica_loop, start_replicas

    reps = distributed.serving_replicas(
        args.mesh, args.dist_backend or distributed.default_backend(device))
    device = distributed.rank_device(device)
    loaded = load_model(args.model, device, eos=eos, mesh=reps.mesh)
    cfg, params = loaded[0], loaded[1]
    engine = Engine(params, cfg, n_slots=2, max_len=args.max_len, seed=reps.index,
                    decode_ticks=1, mesh=reps.mesh, sharded=args.model != "tiny-random",
                    device=device)
    loop = replica_loop(reps, engine)
    if dist.get_rank() != 0:
        loop.run()  # until rank 0 stops the replicas, or any rank fails
        return 1 if loop.error is not None else 0
    if args.model == "tiny-random":  # its whole weights stay on the CPU under a mesh
        params = {**params, "audio": _to_device(params["audio"], device)}
    return (cfg, params) + tuple(loaded[2:]), start_replicas(reps, loop)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


if __name__ == "__main__":
    raise SystemExit(main())
