"""Interactive duplex demo: `python -m vita_tpu_torch.serve.duplex_demo`
(vita_tpu.serve.duplex_demo over the port's Engine).

Two engine replicas under the generate/monitor role-swap controller, fed
by the streaming VAD. It runs on the card unless ``--device cpu`` is given
(without a card it stops); the two Engines share one weights dict there.
``--mesh EXPERT MODEL`` deploys them as two replicas over disjoint ranks of
a torchrun launch of 2*EXPERT*MODEL ranks (duplex_http.serve_replicas):
rank 0 runs the demo and drives both replicas through the controller.

Modes:
  --simulate      synthetic mic session (tones + silence + an interrupt):
                  demonstrates VAD segmentation, <2> noise gating, the
                  audio-interrupt role swap, and sentence-chunked TTS
                  callbacks without hardware. Works with --model
                  tiny-random.
  --wav a.wav [b.wav ...]   feed real wav files as successive utterances.

Each TTS flush is printed as [tts]; streamed text as it arrives; role
swaps and rejections are logged, and final duplex stats are reported.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from vita_tpu_torch.constants import AUDIO_TOKEN_INDEX
from vita_tpu_torch.conversation import TEMPLATES, Dialog
from vita_tpu_torch.serve.duplex import DuplexController
from vita_tpu_torch.serve.engine import Engine, EngineThread, Request
from vita_tpu_torch.serve.vad import CHUNK_SAMPLES, SAMPLE_RATE, StreamingVAD, VADConfig
from vita_tpu_torch.tokenization import (
    audio_token_count,
    expand_media_sentinels,
    media_masks,
    tokenize_multimodal,
)


def synth_session() -> List[np.ndarray]:
    """Silence, a 3 s utterance, loud non-speech noise (must be rejected by
    the trained VAD), a second (interrupting) utterance, then silence."""
    from vita_tpu_torch.serve.vad_model import synth_noise, synth_speech

    rng = np.random.default_rng(7)

    def speech(seconds, seed):
        r = np.random.default_rng(seed)
        n = int(seconds * SAMPLE_RATE)
        return np.concatenate(
            [synth_speech(r, CHUNK_SAMPLES) for _ in range(n // CHUNK_SAMPLES + 1)]
        )[:n]

    def noise(seconds):
        n = int(seconds * SAMPLE_RATE)
        return np.concatenate(
            [synth_noise(rng, CHUNK_SAMPLES) for _ in range(n // CHUNK_SAMPLES + 1)]
        )[:n] * 0.8

    silence = np.zeros(int(1.8 * SAMPLE_RATE), np.float32)
    stream = np.concatenate(
        [silence, speech(3.0, 1), silence, noise(1.0), silence,
         speech(3.0, 2), silence]
    )
    n = len(stream) // CHUNK_SAMPLES
    return list(stream[: n * CHUNK_SAMPLES].reshape(n, CHUNK_SAMPLES))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="VITA duplex interactive demo")
    p.add_argument("--model", default="tiny-random")
    p.add_argument("--simulate", action="store_true")
    p.add_argument("--wav", nargs="*", default=None)
    p.add_argument("--max-new-tokens", type=int, default=48)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--settle-s", type=float, default=8.0,
                   help="seconds to let a response stream before the next utterance")
    p.add_argument("--history-limit", type=int, default=5,
                   help="past turns kept as context for each new utterance")
    p.add_argument("--no-streaming-encode", action="store_true",
                   help="encode each utterance whole after VAD end (the "
                        "reference's behavior) instead of streaming the "
                        "Whale encoder during speech")
    p.add_argument("--camera", default="off",
                   help="'off', 'synthetic', or a video file: buffer the "
                        "last 8 camera frames and attach them to each query "
                        "as video context (reference "
                        "web_interactive_demo.py:706-720)")
    p.add_argument("--tts-dir", default=None,
                   help="directory for per-sentence synthesized wavs "
                        "(default: a temp dir under --simulate, else off)")
    p.add_argument("--no-tts", action="store_true",
                   help="print sentence flushes only; skip synthesis/pacing")
    p.add_argument("--mesh", type=int, nargs=2, metavar=("EXPERT", "MODEL"),
                   default=None,
                   help="per-replica expert x model mesh: a torchrun launch of "
                        "2*EXPERT*MODEL ranks serves the two engines as two replicas "
                        "over disjoint ranks (the reference's 2x TP=2 deployment)")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend under --mesh (default nccl on cards, "
                        "gloo on the CPU; ranks sharing one card need gloo)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--tts-pace", type=float, default=1.5,
                   help="sleep factor x clip duration per played chunk "
                        "(reference text_streamer sleeps 1.5x)")
    args = p.parse_args(argv)

    import torch

    from vita_tpu_torch.data.audio import fbank
    from vita_tpu_torch.serve.duplex_http import serve_replicas
    from vita_tpu_torch.serve.replicas import serve_one

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible to torch; pass --device cpu to run on the CPU")
    # random weights run to max tokens (eos -1)
    served = serve_replicas(args, device, eos=args.model != "tiny-random")
    if isinstance(served, int):  # a rank other than 0: its replica's loop has ended
        return served
    (cfg, params, encode, decode, bos_id, eos_id), engines = served
    threads = engines  # the replicas' loops run already
    if engines is None:
        # two replicas over one weights dict; decode_ticks=1 keeps token
        # delivery smooth for TTS pacing and barge-in
        engines = [Engine(params, cfg, n_slots=2, max_len=args.max_len, seed=i,
                          decode_ticks=1) for i in range(2)]

    # multi-turn context: each utterance carries the session's past audio
    # turns, merged under the interactive demo's rules
    # (web_interactive_demo.py:297-302 global_history usage)
    from vita_tpu_torch.serve.history import ChatSession, HistoryTurn

    session = ChatSession(limit=args.history_limit)
    turn_meta = {}  # request_id -> HistoryTurn (response filled on_turn)

    streaming = not args.no_streaming_encode

    def make_query(segment: np.ndarray,
                   encoded: Optional[np.ndarray] = None,
                   frames: Optional[List[np.ndarray]] = None) -> Request:
        # camera context: the buffered frames become this turn's video
        # tiles (reference attaches an mp4 of the last 8 webcam frames,
        # web_interactive_demo.py:706-720,864-865)
        images = None
        img_counts: List[int] = []
        prompt_text = "<audio>"
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
            merged = session.merge(
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
            merged = session.merge(
                prompt_text, speech=feats, speech_length=len(feats),
                **media_common,
            )
            aud_counts = [audio_token_count(l) for l in merged.speech_lengths]
            media_kw = dict(speech=merged.speeches,
                            speech_length=merged.speech_lengths)
            turn = HistoryTurn(prompt=prompt_text, response="",
                               speech=feats, speech_length=len(feats))
        ids = tokenize_multimodal(merged.prompt, encode, bos_id=bos_id)
        expanded = expand_media_sentinels(
            ids, list(merged.image_slot_counts), aud_counts)
        safe, im, am = media_masks(np.array(expanded))
        req = Request(
            input_ids=safe, audio_mask=am,
            image_mask=im if merged.images is not None else None,
            images=merged.images,
            max_new_tokens=args.max_new_tokens, eos_id=eos_id, **media_kw,
        )
        turn_meta[req.request_id] = turn
        return req

    def on_turn(req: Request, text: str) -> None:
        turn = turn_meta.pop(req.request_id, None)
        if turn is not None:
            turn.response = text
            session.add(turn)

    # Warm both engines (audio embed + prefill chunks + decode chunk) before
    # the real-time session starts: first-use costs (kernel build and load)
    # must not eat the interaction timeline.
    camera = None
    cam_frames: List[np.ndarray] = []
    if args.camera != "off":
        from vita_tpu_torch.serve.camera import (
            CameraBuffer,
            synthetic_camera_frames,
            video_file_frames,
        )

        camera = CameraBuffer(max_frames=8)
        if args.camera == "synthetic":
            cam_frames = synthetic_camera_frames(512, cfg.vision.image_size)
        else:
            cam_frames = video_file_frames(args.camera, cfg.vision.image_size)

    def camera_tiles() -> Optional[List[np.ndarray]]:
        if camera is None or len(camera) == 0:
            return None
        tiles, _ = camera.snapshot_tiles(cfg.vision_fusion)
        return tiles

    t0 = time.time()
    warm_encoder = None
    if streaming:
        from vita_tpu_torch.serve.streaming_audio import StreamingWhaleEncoder

        # warm the streaming step too
        warm_encoder = StreamingWhaleEncoder(params["audio"], cfg.audio)
        warm_encoder.feed(np.zeros((300, cfg.audio.input_dim), np.float32))
        warm_feats = warm_encoder.finish()
        warm_encoder.reset()
    warm_frames = None
    if camera is not None:
        # warm the image+audio prefill too: a camera query in the live
        # timeline must not pay first-use costs
        for f in cam_frames[:8]:
            camera.push(f)
        warm_frames = camera_tiles()
        camera.frames.clear()
    for e in engines:
        if streaming:
            warm = make_query(None, encoded=warm_feats, frames=warm_frames)
        else:
            warm = make_query(np.zeros(int(3.0 * SAMPLE_RATE), np.float32),
                              frames=warm_frames)
        warm.max_new_tokens = 9
        serve_one(e, warm)
    session.turns.clear()  # warm turns are not conversation history
    print(f"[demo] engines warm in {time.time()-t0:.1f}s")

    if threads is None:
        threads = [EngineThread(e) for e in engines]
        for t in threads:
            t.start()

    def on_text(chunk: str) -> None:
        sys.stdout.write(chunk)
        sys.stdout.flush()

    def on_tts(sentence: str) -> None:
        print(f"\n[tts] {sentence.strip()!r}")

    # real TTS: synthesize each sentence off-thread, pace playback by clip
    # duration, drop chunks from interrupted turns (reference tts_worker +
    # text_streamer protocol, web_interactive_demo.py:419-601,743-772)
    tts_worker = streamer = None
    on_sentence = None
    if not args.no_tts:
        import os
        import tempfile

        from vita_tpu_torch.serve.tts import PacedStreamer, TTSWorker, write_wav

        tts_dir = args.tts_dir
        if tts_dir is None and args.simulate:
            tts_dir = tempfile.mkdtemp(prefix="vita_tts_")
        if tts_dir:
            os.makedirs(tts_dir, exist_ok=True)
        from vita_tpu_torch.serve.tts import normalize_tts_text

        tts_worker = TTSWorker()
        turn_seq = {"n": 0}

        def on_sentence(sentence: str, request) -> None:
            if not hasattr(request, "_tts_llm_id"):
                turn_seq["n"] += 1
                request._tts_llm_id = turn_seq["n"]
            if args.model == "tiny-random" and not normalize_tts_text(sentence):
                # random weights emit non-text bytes; transliterate so the
                # synthesis/pacing loop still runs end-to-end in the demo
                sentence = "".join(
                    "aeioubdklmnprst"[ord(c) % 15] for c in sentence) + "."
            tts_worker.submit(request._tts_llm_id, sentence)

        def on_play(chunk) -> None:
            line = f"\n[tts-play] #{chunk.llm_id} {chunk.duration_s:.2f}s {chunk.text!r}"
            if tts_dir:
                path = os.path.join(
                    tts_dir, f"turn{chunk.llm_id:03d}_{len(streamer.played):03d}.wav")
                write_wav(path, chunk.audio)
                line += f" -> {path}"
            print(line)

        streamer = PacedStreamer(
            tts_worker.outputs,
            current_llm_id=lambda: getattr(ctl.current, "_tts_llm_id", 0)
            if ctl.current is not None else 0,
            on_play=on_play,
            pace_factor=args.tts_pace,
        )

    ctl = DuplexController(engines, decode, on_text, on_tts, on_turn=on_turn,
                           on_sentence=on_sentence)

    vad = StreamingVAD(VADConfig(min_dialog_s=1.5))
    if args.wav:
        chunks: List[np.ndarray] = []
        from vita_tpu_torch.data.audio import load_wav

        for path in args.wav:
            wav = load_wav(path)
            n = len(wav) // CHUNK_SAMPLES
            chunks += list(wav[: n * CHUNK_SAMPLES].reshape(n, CHUNK_SAMPLES))
            chunks += [np.zeros(CHUNK_SAMPLES, np.float32)] * 8  # inter-utterance gap
    else:
        chunks = synth_session()

    frontend = None
    if streaming:
        from vita_tpu_torch.serve.streaming_audio import StreamingAudioFrontend

        frontend = StreamingAudioFrontend(params["audio"], cfg.audio, vad=vad)

    print(f"[demo] streaming {len(chunks)} mic chunks "
          f"({len(chunks) * CHUNK_SAMPLES / SAMPLE_RATE:.1f} s of audio)"
          + (" [whale encode overlaps speech]" if streaming else ""))
    n_queries = 0
    for ci, chunk in enumerate(chunks):
        if camera is not None:
            # one camera frame per mic chunk (4 fps at 0.25 s chunks),
            # looping the source like a live feed
            camera.push(cam_frames[ci % len(cam_frames)])
        if streaming:
            t_eos = time.time()
            utt = frontend.process(chunk)
            if utt is None:
                continue
            n_queries += 1
            tiles = camera_tiles()
            print(f"\n[vad] utterance {n_queries}: "
                  f"{len(utt.wav) / SAMPLE_RATE:.2f}s, encode flush "
                  f"{(time.time() - t_eos) * 1e3:.0f}ms "
                  + (f"+ {len(tiles)} video tiles " if tiles else "")
                  + f"-> monitor engine {1 - ctl.generator_idx}")
            ctl.submit_query(make_query(utt.wav, encoded=utt.features,
                                        frames=tiles))
            time.sleep(args.settle_s)  # let the answer stream (real time)
            continue
        seg = vad.process(chunk)
        if seg is not None:
            n_queries += 1
            tiles = camera_tiles()
            print(f"\n[vad] utterance {n_queries}: {len(seg) / SAMPLE_RATE:.2f}s "
                  + (f"+ {len(tiles)} video tiles " if tiles else "")
                  + f"-> monitor engine {1 - ctl.generator_idx}")
            ctl.submit_query(make_query(seg, frames=tiles))
            time.sleep(args.settle_s)  # let the answer stream (real time)

    time.sleep(args.settle_s)
    for t in threads:
        t.stop()
    for t in threads:  # let in-flight work land (clean exit)
        t.join(timeout=60)
    if tts_worker is not None:
        tts_worker.drain()  # let queued sentences synthesize
        t0 = time.time()
        while not tts_worker.outputs.empty() and time.time() - t0 < 30:
            time.sleep(0.05)  # ...and the streamer play them out
        tts_worker.stop()
        streamer.stop()
        print(f"\n[tts] played {len(streamer.played)} chunk(s), "
              f"skipped {streamer.skipped_stale} stale")
    print(f"\n[demo] done: {n_queries} queries, {ctl.interrupts} interrupt(s), "
          f"{ctl.rejected_noise} noise rejection(s), final generator: engine "
          f"{ctl.generator_idx}")
    for i, e in enumerate(engines):
        st = e.stats()
        if st.get("completed"):
            print(f"[engine {i}] completed={st['completed']:.0f} "
                  f"ttft_p50={st.get('ttft_p50_s', 0):.2f}s")
    failed = [t.error for t in threads if getattr(t, "error", None) is not None]
    if failed:
        print(f"[demo] a serving replica failed: {failed[0]!r}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
