"""HTTP serving demo: chat + streaming over the continuous-batching engine
(vita_tpu.serve.http_server over the port's Engine).

A stdlib ThreadingHTTPServer exposing

  GET  /            — minimal chat page (text + image/audio upload)
  GET  /health      — {"status": "ok", "active": N}
  GET  /stats       — serving metrics (p50 TTFT, decode tok/s, queue depth)
  POST /v1/generate — {"prompt": str, "image_b64"?: str, "audio_b64"?: str,
                       "video_b64"?: str, "video_format"?: ".mp4",
                       "session_id"?: str, "max_tokens"?: int,
                       "temperature"?: float}
                      -> chunked text/plain token stream
  POST /v1/chat/completions — OpenAI-compatible (beyond the reference):
                      `messages` with string content or content-part lists
                      (text / image_url / video_url data: URLs /
                      input_audio 16-bit wav); `stream: true` -> SSE
                      chat.completion.chunk events, else one
                      chat.completion JSON with usage counts. Media in the
                      final user message; earlier turns render as history.

``video_b64`` carries a whole video file (any OpenCV-decodable container);
frames are sampled server-side exactly like the CLI/video pipeline
(1 fps patch mode, 3 fps 5-tuple frameCat mode) — the reference's demo
handles video uploads the same way (web_demo/web_ability_demo.py:145-243,
_get_rawvideo_dec). image_b64 and video_b64 are mutually exclusive.

Passing a ``session_id`` turns on multi-turn chat: history replays under
the interactive demo's merge rules (serve.history — skip history vision,
image tokens to the front; web_interactive_demo.py:604-680), so an image
sent in turn 1 stays referenced in later turns.

Launch: python -m vita_tpu_torch.serve.http_server --model tiny-random --port 8800
(on the card; add ``--device cpu`` to run on the CPU). A ``session_id``
also keys the Engine's KV-prefix reuse: a turn that extends the previous
one prefills only its new suffix.

``--mesh EXPERT MODEL [PIPE]`` serves one Engine per rank of a torchrun
launch (``torchrun --nproc-per-node N -m vita_tpu_torch.serve.http_server
--model ... --mesh E M [P]``, N = E * M * P; ``--dist-backend gloo`` when
the ranks share one card): rank 0 serves HTTP and ``/stats``, and its
MeshEngineThread broadcasts each step's new requests and cancellations
to the other ranks, which run the same loop in place of EngineThread.
A pipe axis splits the layers into P stages; ``--slots`` rounds up to a
multiple of P (one wave a stage).
"""

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
from typing import Optional

import numpy as np
import torch

from vita_tpu_torch.tokenization import audio_token_count, media_masks

_PAGE = """<!doctype html><title>VITA demo</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
#log{white-space:pre-wrap;border:1px solid #ccc;padding:1em;min-height:8em}</style>
<h2>VITA chat</h2><div id=log></div>
<input id=q style="width:70%" placeholder="ask something">
<input type=file id=img accept="image/*"><input type=file id=vid accept="video/*"><button onclick=send()>Send</button>
<script>
const sid = 'web-' + Math.random().toString(36).slice(2);
async function send(){
 const q=document.getElementById('q').value;
 const body={prompt:q,max_tokens:128,session_id:sid};
 const f=document.getElementById('img').files[0];
 if(f){body.image_b64=await new Promise(r=>{const fr=new FileReader();
   fr.onload=()=>r(fr.result.split(',')[1]);fr.readAsDataURL(f);});}
 const v=document.getElementById('vid').files[0];
 if(v){body.video_b64=await new Promise(r=>{const fr=new FileReader();
   fr.onload=()=>r(fr.result.split(',')[1]);fr.readAsDataURL(v);});
   body.video_format='.'+(v.name.split('.').pop()||'mp4');}
 const log=document.getElementById('log');log.textContent+='\\n> '+q+'\\n';
 const res=await fetch('/v1/generate',{method:'POST',body:JSON.stringify(body)});
 const rd=res.body.getReader();const dec=new TextDecoder();
 for(;;){const{done,value}=await rd.read();if(done)break;
   log.textContent+=dec.decode(value);}
}
</script>"""


class ServingApp:
    """Holds the engine, tokenizer, and preprocessing for the handlers."""

    def __init__(self, engine, cfg, encode, decode, bos_id, eos_id, image_size=448,
                 history_mode: str = "replay", thread=None):
        from vita_tpu_torch.serve.engine import EngineThread

        self.engine = engine
        self.cfg = cfg
        self.encode, self.decode = encode, decode
        self.bos_id, self.eos_id = bos_id, eos_id
        self.image_size = image_size
        # 'replay' re-sends history media (web_ability_demo.py:132-243);
        # 'interactive' drops history vision + fronts image tokens
        # (web_interactive_demo.py merge_current_and_history call, :297-302)
        if history_mode not in ("replay", "interactive"):
            raise ValueError(f"bad history_mode {history_mode!r}")
        self.history_mode = history_mode
        self.sessions: dict = {}
        self._sessions_lock = threading.Lock()
        # the loop stepping the engine: EngineThread, or rank 0's
        # MeshEngineThread under a mesh (requests then go through it)
        self.thread = thread if thread is not None else EngineThread(engine)
        self.submit = getattr(self.thread, "submit", engine.submit)
        self.thread.start()

    def _decode_media(self, payload: dict):
        """Decode image_b64/video_b64/audio_b64 payload fields into model
        inputs. Returns (parts, images, img_counts, aud_counts, speech,
        speech_len, is_video)."""
        images = speech = None
        speech_len = 0
        img_counts, aud_counts = [], []
        parts = []
        is_video = False

        if payload.get("image_b64"):
            from PIL import Image

            from vita_tpu_torch.data.image import dynamic_tile, dynamic_tile_framecat, normalize

            raw = base64.b64decode(payload["image_b64"])
            arr = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
            if self.cfg.vision_fusion == "framecat":
                tiles = dynamic_tile_framecat(arr, 1, 12, self.image_size)
            elif self.image_size < 448:  # tiny model: single resized tile
                from PIL import Image as I

                tiles = [np.asarray(I.fromarray(arr).resize((self.image_size,) * 2))]
            else:
                tiles = dynamic_tile(arr, 1, 12, self.image_size, True)
            images = normalize(tiles)
            groups = len(tiles) // self.cfg.image_group_tiles
            img_counts = [groups * self.cfg.image_tokens_per_group]
            parts.append("<image>")
        if payload.get("video_b64"):
            if images is not None:
                raise ValueError("image_b64 and video_b64 are mutually exclusive")
            import os
            import tempfile

            from vita_tpu_torch.data.image import normalize
            from vita_tpu_torch.data.video import (
                decode_video_frames,
                decode_video_frames_framecat,
            )

            raw = base64.b64decode(payload["video_b64"])
            suffix = payload.get("video_format", ".mp4")
            if not suffix.startswith("."):
                suffix = "." + suffix
            fd, tmp = tempfile.mkstemp(suffix=suffix)
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(raw)
                if self.cfg.vision_fusion == "framecat":
                    frames = decode_video_frames_framecat(tmp, size=self.image_size)
                else:
                    frames = decode_video_frames(tmp, size=self.image_size)
            finally:
                os.unlink(tmp)
            images = normalize(list(frames))
            groups = len(frames) // self.cfg.image_group_tiles
            img_counts = [groups * self.cfg.image_tokens_per_group]
            is_video = True
            parts.append("<image>")
        if payload.get("audio_b64"):
            from vita_tpu_torch.data.audio import fbank

            raw = np.frombuffer(base64.b64decode(payload["audio_b64"]), np.int16)
            speech = fbank(raw.astype(np.float32) / 32768.0)
            speech_len = len(speech)
            aud_counts = [audio_token_count(speech_len)]
            parts.append("<audio>")
        return parts, images, img_counts, aud_counts, speech, speech_len, is_video

    def build_request(self, payload: dict):
        """Returns (Request, record_turn(response_text) or None, release)."""
        from vita_tpu_torch.conversation import TEMPLATES, Dialog
        from vita_tpu_torch.serve.engine import Request
        from vita_tpu_torch.serve.history import ChatSession, HistoryTurn
        from vita_tpu_torch.tokenization import expand_media_sentinels, tokenize_multimodal

        prompt_text = payload.get("prompt", "")
        (parts, images, img_counts, aud_counts, speech, speech_len,
         is_video) = self._decode_media(payload)
        if prompt_text and not payload.get("audio_b64"):
            parts.append(prompt_text)
        user_text = "\n".join(parts)

        session_id = payload.get("session_id")
        record = None
        release = lambda: None
        if session_id:
            with self._sessions_lock:
                sess = self.sessions.setdefault(session_id, ChatSession())
            # serialize this session's merge -> generate -> record: a
            # concurrent same-session request would otherwise merge a
            # half-updated history (the handler releases after record)
            sess.lock.acquire()
            release = sess.lock.release
            interactive = self.history_mode == "interactive"
            cur_images, cur_counts = images, tuple(img_counts)
            merged = sess.merge(
                user_text, images=images, image_slot_counts=tuple(img_counts),
                speech=speech, speech_length=speech_len,
                skip_history_vision=interactive,
                image_tokens_to_front=interactive,
            )
            prompt = merged.prompt
            images = merged.images
            img_counts = list(merged.image_slot_counts)
            speeches = merged.speeches
            aud_counts = [audio_token_count(l) for l in merged.speech_lengths]
            req_speech = speeches if speeches else None
            req_speech_len = merged.speech_lengths

            turn = HistoryTurn(
                prompt=user_text, response="",
                images=cur_images, image_slot_counts=cur_counts,
                speech=speech, speech_length=speech_len,
            )

            def record(text, turn=turn, sess=sess):
                turn.response = text
                sess.add(turn)
        else:
            modality = ("video" if is_video else
                        "image" if images is not None else "lang")
            prompt = Dialog(TEMPLATES["mixtral_two"]).user(user_text).assistant().render(modality)
            req_speech = speech
            req_speech_len = speech_len

        try:
            ids = tokenize_multimodal(prompt, self.encode, bos_id=self.bos_id)
            expanded = expand_media_sentinels(ids, img_counts, aud_counts)
            safe, im, am = media_masks(np.array(expanded))
        except Exception:
            release()
            raise

        return Request(
            input_ids=safe,
            image_mask=im if images is not None else None,
            audio_mask=am if am.any() else None,
            images=images, speech=req_speech,
            speech_length=req_speech_len,
            max_new_tokens=int(payload.get("max_tokens", 256)),
            temperature=float(payload.get("temperature", 0.0)),
            eos_id=self.eos_id,
            # text-only session turns reuse the previous turn's KV prefix
            session_key=session_id,
        ), record, release

    def build_openai_request(self, body: dict):
        """OpenAI-compatible /v1/chat/completions adapter: `messages` with
        string content or content-part lists ({'type':'text'},
        {'type':'image_url','image_url':{'url':'data:...;base64,...'}},
        {'type':'input_audio','input_audio':{'data': b64-wav}}). Media is
        accepted in the FINAL user message; earlier turns render as text
        history through the mixtral_two template. Returns a Request."""
        from vita_tpu_torch.conversation import TEMPLATES, Dialog
        from vita_tpu_torch.serve.engine import Request
        from vita_tpu_torch.tokenization import expand_media_sentinels, tokenize_multimodal

        msgs = body.get("messages") or []
        if not msgs or msgs[-1].get("role") != "user":
            raise ValueError("messages must end with a user message")

        def flatten(content, payload, final):
            texts = []
            if isinstance(content, str):
                return content
            for part in content or []:
                kind = part.get("type")
                if kind == "text":
                    texts.append(part.get("text", ""))
                elif kind in ("image_url", "video_url", "input_audio"):
                    if not final:
                        raise ValueError(
                            "media is only supported in the final user message"
                        )
                    if kind == "input_audio":
                        import io as _io
                        import wave

                        raw = base64.b64decode(part["input_audio"]["data"])
                        with wave.open(_io.BytesIO(raw)) as w:
                            if w.getsampwidth() != 2:
                                raise ValueError("input_audio must be 16-bit wav")
                            pcm = w.readframes(w.getnframes())
                        payload["audio_b64"] = base64.b64encode(pcm).decode()
                    else:
                        url = part[kind]["url"] if isinstance(part.get(kind), dict) \
                            else part.get(kind, "")
                        if not url.startswith("data:"):
                            raise ValueError(
                                f"{kind} must be a data: URL (no egress)"
                            )
                        b64 = url.split(",", 1)[1]
                        key = "image_b64" if kind == "image_url" else "video_b64"
                        payload[key] = b64
                else:
                    raise ValueError(f"unsupported content part {kind!r}")
            return "\n".join(t for t in texts if t)

        payload: dict = {}
        final_text = flatten(msgs[-1].get("content"), payload, final=True)
        (parts, images, img_counts, aud_counts, speech, speech_len,
         is_video) = self._decode_media(payload)
        if final_text and "audio_b64" not in payload:
            parts.append(final_text)
        user_text = "\n".join(parts)

        dlg = Dialog(TEMPLATES["mixtral_two"])
        pending_user = None
        for m in msgs[:-1]:
            role = m.get("role")
            text = flatten(m.get("content"), {}, final=False)
            if role == "user":
                pending_user = text
            elif role == "assistant":
                dlg = dlg.user(pending_user or "").assistant(text)
                pending_user = None
            # system messages: the mixtral_two template carries VITA's own
            # per-modality system prompts; client system text is ignored
        if pending_user is not None:
            user_text = pending_user + "\n" + user_text
        modality = ("video" if is_video else
                    "image" if images is not None else "lang")
        prompt = dlg.user(user_text).assistant().render(modality)

        ids = tokenize_multimodal(prompt, self.encode, bos_id=self.bos_id)
        expanded = expand_media_sentinels(ids, img_counts, aud_counts)
        safe, im, am = media_masks(np.array(expanded))
        return Request(
            input_ids=safe,
            image_mask=im if images is not None else None,
            audio_mask=am if am.any() else None,
            images=images, speech=speech, speech_length=speech_len,
            max_new_tokens=int(body.get("max_tokens",
                                        body.get("max_completion_tokens", 256))),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),  # non-OpenAI extension
            eos_id=self.eos_id,
        )


def make_handler(app: ServingApp):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer-encoding is an HTTP/1.1 feature: on the default
        # HTTP/1.0 status line, compliant clients do not de-chunk and the
        # raw framing leaks into the body
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/stats":
                body = json.dumps(app.engine.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                body = json.dumps({"object": "list", "data": [
                    {"id": "vita-tpu", "object": "model",
                     "owned_by": "vita-tpu"}]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                body = json.dumps(
                    {"status": "ok", "active": app.engine.active_count()}
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path == "/v1/chat/completions":
                self._chat_completions()
                return
            if self.path != "/v1/generate":
                self.send_error(404)
                return
            release = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                req, record, release = app.build_request(payload)
                tok_q: "queue.Queue[Optional[int]]" = queue.Queue()
                req.on_token = tok_q.put
                req.on_finish = lambda toks, reason: tok_q.put(None)
                app.submit(req)  # may reject on cache capacity
            except Exception as e:  # malformed request / over capacity
                if release is not None:
                    release()
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return

            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def clean_text(ids, final):
                text = app.decode(ids).replace("</s>", "")
                for st in ("<1>", "<2>", "<3>"):
                    text = text.replace(st, "")
                # a token boundary can split a multi-byte character: hold a
                # trailing replacement char until it decodes for real
                if not final:
                    text = text.rstrip("\ufffd")
                return text

            sent = ""
            toks = []
            try:
                while True:
                    t = tok_q.get()
                    if t is None:
                        break
                    toks.append(t)
                    text = clean_text(toks, final=False)
                    # emit only a monotonic extension of what was sent:
                    # stripping a just-completed state token SHRINKS the
                    # text, and a naive length diff would misalign forever
                    if text.startswith(sent) and len(text) > len(sent):
                        chunk = text[len(sent):].encode()
                        self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        sent = text
                final = clean_text(toks, final=True)
                if final.startswith(sent) and len(final) > len(sent):
                    chunk = final[len(sent):].encode()
                    self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                if record is not None:  # persist the turn for the session
                    record(app.decode(toks).replace("</s>", ""))
            except (BrokenPipeError, ConnectionResetError):
                req.cancel()  # client went away: free the slot
            finally:
                if release is not None:
                    release()

        def _chat_completions(self):
            """OpenAI-compatible endpoint: non-stream returns one
            chat.completion object; stream=true sends SSE
            chat.completion.chunk events (chunked transfer)."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                req = app.build_openai_request(body)
                tok_q: "queue.Queue[Optional[int]]" = queue.Queue()
                done: dict = {}
                req.on_token = tok_q.put
                req.on_finish = lambda toks, reason: (
                    done.update(reason=reason), tok_q.put(None))
                app.submit(req)
            except Exception as e:
                err = json.dumps({"error": {"message": str(e),
                                            "type": "invalid_request_error"}}).encode()
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(err)))
                self.end_headers()
                self.wfile.write(err)
                return

            rid = f"chatcmpl-{int(time.time() * 1000):x}"
            model = body.get("model", "vita-tpu")
            created = int(time.time())
            stream = bool(body.get("stream"))
            stops = body.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            stopped = []  # truth: a stop sequence ended the generation

            def clean(ids, final):
                text = app.decode(ids).replace("</s>", "")
                for st in ("<1>", "<2>", "<3>"):
                    text = text.replace(st, "")
                return text if final else text.rstrip("\ufffd")

            def cut_stop(text):
                """Truncate at the earliest stop sequence (OpenAI semantics:
                the stop text itself is not returned); cancels the request
                so the engine frees the slot (KeywordsStoppingCriteria's
                role, vita/util/mm_utils.py:121-155)."""
                cut = -1
                for s in stops:
                    i = text.find(s)
                    if i != -1 and (cut == -1 or i < cut):
                        cut = i
                if cut == -1:
                    return text, False
                if not stopped:
                    stopped.append(True)
                    req.cancel()
                return text[:cut], True

            def finish_reason():
                if stopped:
                    return "stop"
                return "stop" if done.get("reason") == "eos" else "length"

            toks: list = []
            if not stream:
                try:
                    while True:
                        t = tok_q.get()
                        if t is None:
                            break
                        toks.append(t)
                        if stops and cut_stop(clean(toks, False))[1]:
                            break
                except (BrokenPipeError, ConnectionResetError):
                    req.cancel()
                    return
                content, _ = cut_stop(clean(toks, True))
                out = json.dumps({
                    "id": rid, "object": "chat.completion",
                    "created": created, "model": model,
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant",
                                             "content": content},
                                 "finish_reason": finish_reason()}],
                    "usage": {"prompt_tokens": len(req.input_ids),
                              "completion_tokens": len(toks),
                              "total_tokens": len(req.input_ids) + len(toks)},
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)
                return

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def sse(obj):
                data = b"data: " + json.dumps(obj).encode() + b"\n\n"
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

            def chunk_obj(delta, reason=None):
                return {"id": rid, "object": "chat.completion.chunk",
                        "created": created, "model": model,
                        "choices": [{"index": 0, "delta": delta,
                                     "finish_reason": reason}]}

            sent = ""
            try:
                sse(chunk_obj({"role": "assistant", "content": ""}))
                while True:
                    t = tok_q.get()
                    if t is None:
                        break
                    toks.append(t)
                    text, hit = cut_stop(clean(toks, final=False))
                    if not hit:
                        # withhold any trailing partial stop-sequence
                        # prefix: it must never reach the client if the
                        # next tokens complete the stop
                        h = 0
                        for s in stops:
                            m = min(len(s) - 1, len(text))
                            for k in range(m, 0, -1):
                                if text.endswith(s[:k]):
                                    h = max(h, k)
                                    break
                        text = text[: len(text) - h]
                    if text.startswith(sent) and len(text) > len(sent):
                        sse(chunk_obj({"content": text[len(sent):]}))
                        sent = text
                    if hit:
                        break
                final, _ = cut_stop(clean(toks, final=True))
                if final.startswith(sent) and len(final) > len(sent):
                    sse(chunk_obj({"content": final[len(sent):]}))
                sse(chunk_obj({}, reason=finish_reason()))
                data = b"data: [DONE]\n\n"
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                req.cancel()

    return Handler


def load_model(model: str, device: torch.device, eos: bool = True, mesh=None):
    """(cfg, params on ``device``, encode, decode, bos_id, eos_id) for
    ``--model``: 'tiny-random' (VITAConfig.tiny() with weights from a
    seeded generator and the byte tokenizer; eos_id -1 when ``eos`` is
    False, so random weights run to max tokens) or a checkpoint directory
    with its tokenizer. Under a serving ``mesh`` tiny-random's full
    weights stay on the CPU and a checkpoint is read as this rank's shards
    (``load_vita_checkpoint(..., mesh=)``)."""
    from vita_tpu_torch.cli import ByteTokenizer, load_hf_tokenizer
    from vita_tpu_torch.models import vita

    if model == "tiny-random":
        if mesh is not None:
            device = torch.device("cpu")
        cfg = vita.VITAConfig.tiny()
        params = vita.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
        tok = ByteTokenizer()
        return cfg, params, tok.encode, tok.decode, tok.bos_id, tok.eos_id if eos else -1
    from vita_tpu_torch.checkpoint import load_vita_checkpoint

    cfg, params = load_vita_checkpoint(model, device, mesh=mesh)
    hf_tok = load_hf_tokenizer(model)
    return (cfg, params, lambda s: hf_tok(s).input_ids,
            lambda ids: hf_tok.decode(ids, skip_special_tokens=False),
            hf_tok.bos_token_id, hf_tok.eos_token_id)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=4096)
    p.add_argument("--history-mode", default="replay",
                   choices=["replay", "interactive"],
                   help="multi-turn handling for session_id requests: replay "
                        "re-sends history media; interactive drops history "
                        "vision and fronts image tokens")
    p.add_argument("--mesh", type=int, nargs="+", metavar="AX",
                   default=None,
                   help="serving mesh EXPERT MODEL [PIPE] over the ranks of a torchrun "
                        "launch (PIPE: pipeline stages; --slots rounds up to a multiple)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend under --mesh (default nccl on cards, "
                        "gloo on the CPU; ranks sharing one card need gloo)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache pages (half the bytes of a bf16 page "
                        "per token; uses 128-token pages)")
    p.add_argument("--decode-ticks", type=int, default=4,
                   help="decode chunks chained per host loop in pure-decode "
                        "phases (higher = less host overhead per token, "
                        "burstier streaming; 1 = smoothest cadence)")
    p.add_argument("--warmup", default=None, action="store_true",
                   help="run dummy requests through every prompt bucket at "
                        "startup (default on for real checkpoints, off for "
                        "tiny-random) so the first request pays no first-use "
                        "costs (kernel build and load)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    from vita_tpu_torch.serve.engine import Engine, MeshEngineThread

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch; pass --device cpu to run on the CPU")
    mesh, rank, say = None, 0, print
    n_slots = args.slots
    if args.mesh is not None:
        import torch.distributed as dist

        from vita_tpu_torch.parallel import distributed

        mesh = distributed.serving_mesh(
            args.mesh, args.dist_backend or distributed.default_backend(device))
        device, rank = distributed.rank_device(device), dist.get_rank()
        if rank != 0:
            say = lambda *a, **k: None  # noqa: E731 - rank 0 speaks for the mesh
        pipe = args.mesh[2] if len(args.mesh) == 3 else 1
        n_slots = -(-n_slots // pipe) * pipe  # one wave a stage
    # under a mesh only this rank's shards reach its device
    cfg, params, encode, decode, bos_id, eos_id = load_model(args.model, device, mesh=mesh)
    engine = Engine(params, cfg, n_slots=n_slots, max_len=args.max_len,
                    decode_ticks=args.decode_ticks, kv_int8=args.kv_int8,
                    page_size=128 if args.kv_int8 else 64, mesh=mesh,
                    sharded=mesh is not None and args.model != "tiny-random", device=device)
    del params
    warmup = args.warmup
    if warmup is None:
        warmup = args.model != "tiny-random"
    if warmup:
        say("[serve] warming the serving path ...", flush=True)
        t0 = time.time()
        engine.warmup(media=True)
        say(f"[serve] warmup done in {time.time() - t0:.1f}s")
    runner = MeshEngineThread(engine) if mesh is not None else None
    if rank != 0:
        runner.run()  # until rank 0 stops, or any rank fails
        return 1 if runner.error is not None else 0
    app = ServingApp(engine, cfg, encode, decode, bos_id, eos_id,
                     image_size=cfg.vision.image_size,
                     history_mode=args.history_mode, thread=runner)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    if runner is not None:  # a failed mesh stops the server
        runner.on_error = server.shutdown
        if runner.error is not None:  # it failed before it could
            return 1
    print(f"[serve] listening on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        app.thread.stop()
        app.thread.join(timeout=60)
    if runner is not None and runner.error is not None:
        print(f"[serve] the serving mesh failed: {runner.error!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
