"""Generation: bucketed multimodal prefill and chunked decode
(vita_tpu.generate).

- Prompts, image tiles and audio frames pad to fixed buckets, as in the
  JAX package, so the Engine and the Generator see the same padded shapes
  as the reference.
- ``Generator`` serves one sequence: the whole prompt bucket prefills in
  one call into a linear KV cache of ``max_len`` rows, then
  sampling.decode_chunk advances ``chunk_len`` tokens per host readback
  (one ``.cpu()`` per chunk). Chunks are launched one ahead of the
  readback, as in the JAX package; the first token is streamed as soon as
  prefill has sampled it.
- Stop handling (eos, stop sequences in the manner of the reference's
  KeywordsStoppingCriteria, max tokens) stays on the host, applied per
  chunk with exact truncation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vita_tpu_torch.models import mixtral, vita
from vita_tpu_torch.models.whale import subsampled_length
from vita_tpu_torch.sampling import choose_sampling_mode, decode_chunk, sample_tokens
from vita_tpu_torch.tokenization import audio_select_arrays, audio_token_count, pad_to_bucket

DEFAULT_PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
DEFAULT_TILE_BUCKETS = (1, 5, 13)  # dynamic-patch counts: 1 tile .. 12+thumbnail
DEFAULT_FRAME_BUCKETS = (400, 800, 1600, 3200, 6400)  # 10ms fbank frames
CLIP_COUNT_BUCKETS = (1, 2, 4, 8, 16)
DECODE_MOE_MODES = ("dense", "capacity", "sort", "gather", "gather_q", "gather_q4")
PREFILL_MOE_MODES = ("dense", "capacity", "sort", "gmm")


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 512
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filter
    top_p: float = 1.0  # nucleus sampling threshold
    eos_id: int = 2  # </s>
    # generation stops when the output ends with any of these id sequences
    stop_sequences: tuple = ()


def stop_sequences_from_keywords(keywords, encode, bos_id=None):
    """Stop id-sequences from keyword strings, a leading BOS stripped."""
    seqs = []
    for kw in keywords:
        ids = encode(kw)
        if bos_id is not None and len(ids) > 1 and ids[0] == bos_id:
            ids = ids[1:]
        seqs.append(tuple(ids))
    return tuple(seqs)


def ends_with_stop(tokens, stop_sequences) -> bool:
    for seq in stop_sequences:
        n = len(seq)
        if n and len(tokens) >= n and tuple(tokens[-n:]) == tuple(seq):
            return True
    return False


def pad_axis0(x: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Zero-pad axis 0 of ``x`` up to the smallest bucket >= its length.
    Lengths beyond the largest bucket are left as they are."""
    n = x.shape[0]
    for b in sorted(buckets):
        if n <= b:
            return x if n == b else np.pad(x, [(0, b - n)] + [(0, 0)] * (x.ndim - 1))
    return x


def _stack_clips(clips, lens: List[int], buckets: Sequence[int]):
    """Pad each clip to its bucket, then to the longest, then the clip
    count to its bucket (padding clips have length 1 and are never
    selected by the merge)."""
    padded = [pad_axis0(np.asarray(c, np.float32), buckets) for c in clips]
    t = max(p.shape[0] for p in padded)
    padded = [np.pad(p, ((0, t - p.shape[0]), (0, 0))) for p in padded]
    nb = next((b for b in CLIP_COUNT_BUCKETS if b >= len(padded)), len(padded))
    while len(padded) < nb:
        padded.append(np.zeros((t, padded[0].shape[1]), np.float32))
        lens.append(1)
    return np.stack(padded), np.asarray(lens, np.int32)


def _clip_lengths(clips, length) -> List[int]:
    if isinstance(length, (list, tuple, np.ndarray)):
        lens = [int(x) for x in length]
    else:
        lens = [int(length or clips[0].shape[0])]
    if len(lens) != len(clips):
        raise ValueError(f"{len(clips)} clips but {len(lens)} lengths")
    return lens


def stack_speech_clips(
    speech, speech_length, frame_buckets: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """One-or-many fbank clips -> (clips [n_bucket, T_bucket, 80], lengths
    [n_bucket], per-clip LLM token counts)."""
    clips = list(speech) if isinstance(speech, (list, tuple)) else [speech]
    lens = _clip_lengths(clips, speech_length)
    counts = [audio_token_count(n) for n in lens]
    stacked, lengths = _stack_clips(clips, lens, frame_buckets)
    return stacked, lengths, counts


def stack_encoded_clips(
    encoded, encoded_length, frame_buckets: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """stack_speech_clips for Whale features encoded ahead of time
    ([T', hidden] clips); buckets are the frame buckets after
    subsampling, token counts the adapter's (T'-1)//2+1."""
    clips = list(encoded) if isinstance(encoded, (list, tuple)) else [encoded]
    lens = _clip_lengths(clips, encoded_length)
    counts = [(n - 1) // 2 + 1 for n in lens]
    sub_buckets = sorted({int(subsampled_length(b)) for b in frame_buckets})
    stacked, lengths = _stack_clips(clips, lens, sub_buckets)
    return stacked, lengths, counts


def prompt_buckets_for(prompt_buckets: Sequence[int], max_len: int, round_to: int = 1):
    """The buckets that fit ``max_len``, with ``max_len`` (rounded up to a
    multiple of ``round_to``) appended when the largest falls short."""
    buckets = sorted(b for b in prompt_buckets if b <= max_len)
    if not buckets or buckets[-1] < max_len:
        buckets.append(-(-max_len // round_to) * round_to)
    return tuple(buckets)


def tile_buckets_for(cfg: vita.VITAConfig, tile_buckets: Sequence[int]):
    """Tile buckets rounded up to whole <image> groups (framecat tiles come
    in 5-tuples)."""
    g = cfg.image_group_tiles
    return tuple(sorted({-(-b // g) * g for b in tile_buckets}))


@torch.no_grad()
def embed_prompt(
    params,
    cfg: vita.VITAConfig,
    ids: np.ndarray,  # [bucket] padded ids
    device: torch.device,
    tile_buckets: Sequence[int],
    frame_buckets: Sequence[int],
    image_mask=None,  # [<= bucket] bool; shorter masks pad with False
    audio_mask=None,
    images=None,  # [N_tiles, H, W, 3]
    speech=None,  # [T, 80] or a list of clips
    speech_length: Any = 0,
    audio_encoded=None,  # pre-encoded Whale features, in place of speech
    audio_encoded_length: Any = 0,
) -> torch.Tensor:
    """Token embeddings of one padded prompt with its media merged in:
    [1, bucket, D]. Image tiles and audio clips pad to their buckets."""
    bucket = len(ids)

    def tensor(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    ids_d = tensor(ids, torch.int64)[None]
    if images is None and speech is None and audio_encoded is None:
        return params["llm"]["embed"][ids_d]

    def padmask(m):
        out = np.zeros(bucket, bool)
        if m is not None:
            mm = np.asarray(m, bool)
            out[: len(mm)] = mm
        return out

    am = padmask(audio_mask)
    kw: Dict[str, Any] = {}
    if images is not None:
        kw["images"] = tensor(pad_axis0(np.asarray(images, np.float32), tile_buckets))
    if speech is not None or audio_encoded is not None:
        if speech is not None:
            clips, lens, counts = stack_speech_clips(speech, speech_length, frame_buckets)
            kw["speech"], kw["speech_lengths"] = tensor(clips), tensor(lens)
        else:
            clips, lens, counts = stack_encoded_clips(
                audio_encoded, audio_encoded_length, frame_buckets)
            kw["audio_encoded"], kw["audio_encoded_lengths"] = tensor(clips), tensor(lens)
        ci, ri = audio_select_arrays(am, counts)
        kw["audio_select"] = (tensor(ci)[None], tensor(ri)[None])
    return vita.fuse_embeddings(
        params, cfg, ids_d, image_mask=tensor(padmask(image_mask))[None],
        audio_mask=tensor(am)[None], **kw,
    )


def moe_modes(cfg: vita.VITAConfig, decode_moe_mode: Optional[str],
              prefill_moe_mode: Optional[str]) -> Tuple[str, str]:
    """The (decode, prefill) MoE modes, None inheriting the model's: a
    gmm model decodes through the selected-expert 'gather' path."""
    if decode_moe_mode is None:
        decode_moe_mode = "gather" if cfg.llm.moe_mode == "gmm" else cfg.llm.moe_mode
    if prefill_moe_mode is None:
        prefill_moe_mode = cfg.llm.moe_mode
    if decode_moe_mode not in DECODE_MOE_MODES:
        raise ValueError(f"bad decode_moe_mode {decode_moe_mode!r}")
    if prefill_moe_mode not in PREFILL_MOE_MODES:
        raise ValueError(f"bad prefill_moe_mode {prefill_moe_mode!r}")
    return decode_moe_mode, prefill_moe_mode


def decode_params(params, decode_moe_mode: str):
    """The LLM weights decode reads: an int8 / int4 copy of the experts for
    'gather_q' / 'gather_q4', else the weights as they are."""
    if decode_moe_mode in ("gather_q", "gather_q4"):
        return mixtral.quantize_moe_for_decode(
            params["llm"], bits=4 if decode_moe_mode == "gather_q4" else 8)
    return params["llm"]


class Generator:
    """Single-sequence generation for one model, on ``device`` (None:
    where the weights are)."""

    def __init__(
        self,
        params,
        cfg: vita.VITAConfig,
        max_len: int = 4096,
        chunk_len: int = 8,
        prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
        tile_buckets: Sequence[int] = DEFAULT_TILE_BUCKETS,
        frame_buckets: Sequence[int] = DEFAULT_FRAME_BUCKETS,
        decode_moe_mode: Optional[str] = None,  # None = inherit cfg.llm.moe_mode
        prefill_moe_mode: Optional[str] = None,
        device: Optional[torch.device] = None,
    ):
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.chunk_len = chunk_len
        self.device = torch.device(
            device if device is not None else params["llm"]["embed"].device)
        self.prompt_buckets = prompt_buckets_for(prompt_buckets, max_len)
        self.tile_buckets = tile_buckets_for(cfg, tile_buckets)
        self.frame_buckets = tuple(sorted(frame_buckets))
        decode_mode, prefill_mode = moe_modes(cfg, decode_moe_mode, prefill_moe_mode)
        self._decode_cfg = dataclasses.replace(cfg.llm, moe_mode=decode_mode)
        self._prefill_cfg = dataclasses.replace(cfg.llm, moe_mode=prefill_mode)
        self._decode_llm = decode_params(params, decode_mode)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    @torch.no_grad()
    def _prefill(self, embeds, true_len: int, knobs, generator, mode: str):
        """The whole bucket into a fresh linear cache of max_len rows; the
        token after row true_len - 1. Returns (token [1], cache)."""
        llm = self.cfg.llm
        cache = mixtral.init_kv_cache(llm, 1, self.max_len, device=self.device)
        valid = torch.arange(self.max_len, device=self.device)[None] < true_len
        hidden, cache, _ = mixtral.forward(
            self.params["llm"], self._prefill_cfg, inputs_embeds=embeds,
            attn_valid=valid, cache=cache, return_hidden=True,
        )
        logits = hidden[:, true_len - 1] @ self.params["llm"]["lm_head"]
        return sample_tokens(logits, generator, *knobs, mode=mode), cache

    def generate(
        self,
        input_ids: np.ndarray,  # [S] sentinel-free ids
        image_mask: Optional[np.ndarray] = None,
        audio_mask: Optional[np.ndarray] = None,
        images: Optional[np.ndarray] = None,
        speech=None,  # [T, 80] or a list of clips (multi-turn audio)
        speech_length=None,  # int or list of ints
        gen: Optional[GenerationConfig] = None,
        seed: int = 0,
        on_token=None,
    ) -> List[int]:
        """Single-sequence generation. Returns new token ids (no prompt)."""
        gen = gen or GenerationConfig()
        s = len(input_ids)
        if s + gen.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({gen.max_new_tokens}) exceeds "
                f"cache capacity {self.max_len}"
            )
        padded, _ = pad_to_bucket(input_ids, self.prompt_buckets, pad_id=0)
        embeds = embed_prompt(
            self.params, self.cfg, np.asarray(padded, np.int64), self.device,
            self.tile_buckets, self.frame_buckets, image_mask=image_mask,
            audio_mask=audio_mask, images=images, speech=speech, speech_length=speech_length,
        )
        knobs = (self._tensor([gen.temperature], torch.float32),
                 self._tensor([gen.top_k], torch.int32),
                 self._tensor([gen.top_p], torch.float32))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        # greedy requests skip the full-vocab sort, in prefill too
        mode = choose_sampling_mode(gen.temperature, gen.top_k, gen.top_p)
        first, cache = self._prefill(embeds, s, knobs, generator, mode)
        active = torch.ones(1, dtype=torch.bool, device=self.device)

        def launch(cache, tok, pos):
            return decode_chunk(
                self._decode_llm, cache, tok, self._tensor([pos], torch.int32), active,
                *knobs, generator, llm_cfg=self._decode_cfg, chunk_len=self.chunk_len,
                sampling_mode=mode,
            )

        if on_token is not None:
            on_token(int(first[0]))  # streamed before its chunk runs
        streamed_first = on_token is not None
        # chunk i+1 is launched before chunk i's tokens are read back
        cache, pending, tok = launch(cache, first, s)
        pos = s + self.chunk_len
        out: List[int] = []
        while True:
            want_more = len(out) + self.chunk_len < gen.max_new_tokens
            nxt = launch(cache, tok, pos) if want_more else None
            for t in pending.cpu().numpy()[0]:
                t = int(t)
                out.append(t)
                if on_token is not None and not (streamed_first and len(out) == 1):
                    on_token(t)
                if (t == gen.eos_id or ends_with_stop(out, gen.stop_sequences)
                        or len(out) >= gen.max_new_tokens):
                    return out
            if nxt is None:
                return out
            cache, pending, tok = nxt
            pos += self.chunk_len
