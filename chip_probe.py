#!/usr/bin/env python3
"""Measurements behind PERF.md that chip_smoke.py does not take, on one
NVIDIA GPU.

    python3 chip_probe.py profile   # where served decode's time goes, at decode_inflight 1 and 2
    python3 chip_probe.py syncs     # host waits for the card in pure-decode Engine ticks
    python3 chip_probe.py bounds    # the expert kernels' bounds at the probes' shapes (no card)
    python3 chip_probe.py warps     # warps per block of csrc/expert_ffn.cu
    python3 chip_probe.py gmm       # where the Generator's gmm prefill goes
    python3 chip_probe.py train     # where a training step's time goes
    python3 chip_probe.py flash     # B10 and B11 at the training shapes
    python3 chip_probe.py gmm-kernels  # B5a and B12 at the main paths' shapes
    python3 chip_probe.py gmm-tiles    # stages, wgmma groups in flight, group of B5a/B12
    python3 chip_probe.py flash-fwd    # B1 at the serving, training and Generator shapes
    python3 chip_probe.py flash-fwd-tiles  # K/V ring stages of bf16 B1
    python3 chip_probe.py gmm-small    # B5b at the serving and training steps' R
    python3 chip_probe.py gmm-small-order  # bf16 B5b's tile order: weights-once vs groups of 16
    python3 chip_probe.py expert       # bf16 B3 at T 1, 3 and B4 at T 4, 8, 16
    python3 chip_probe.py expert-ring  # ring, down split and column tile of bf16 B3/B4
    python3 chip_probe.py expert-q4    # bf16 B8b (int4 masked experts) at T 8 and 16
    python3 chip_probe.py expert-q4-ring  # ring stages and down split of bf16 B8b
    python3 chip_probe.py expert-q     # bf16 B7 (int4) and B6 (int8) at T 1, 3; B8a at T 4, 8, 16
    python3 chip_probe.py paged        # B2 and B9 at phase 2's, long and served shapes
    python3 chip_probe.py paged-ring   # ring stages of B2/B9 on tensor cores
    python3 chip_probe.py session      # TTFT of a reused session turn against a cold prefill
    python3 chip_probe.py whale        # where Whale's flash and xla forwards spend their time
    python3 chip_probe.py mesh         # how far sharded serving's logits move, by mesh axis
    python3 chip_probe.py mesh-faults  # which of phase 11's checks fail each planted mesh fault
    python3 chip_probe.py ring         # where ring attention's forward + backward spends its time
    python3 chip_probe.py ring-faults  # which of phase 12's (a) and (b) checks fail each planted fault
    python3 chip_probe.py pp           # where pipeline-parallel decode's time goes (pipe 4)
    python3 chip_probe.py pp-faults    # which of phase 13's (a) and (c) checks fail each planted fault
    python3 chip_probe.py tp-faults    # phase 15(b)'s gradients by leaf, as committed and each planted fault
    python3 chip_probe.py fsdp         # where a ZeRO-3 training step's time goes (fsdp 4)
    python3 chip_probe.py dp-serve     # where full-width serving over fsdp 4 spends its time
    python3 chip_probe.py dp-faults    # which of phase 14's (a) and (d) checks fail planted faults

profile: chip_smoke.py's full-width 4-layer slice served by three engines
on 8 slots (bf16 experts over bf16 KV pages; int4 experts over int8 KV
pages; int8 experts over int8 KV pages), each at decode_inflight 1 and 2
(the Engine's default), under torch.profiler: one text request alone,
then eight text requests at once, 64 new tokens each, each after a
warm-up with the same traffic. Prints per run the wall time (profiler
overhead included), the device time (the sum of the kernels' and copies'
durations), the busy share (device over wall), the largest device
entries and the host's kernel launches.

syncs: the bf16 engine of profile serves one text request of 512 new
tokens; once it decodes alone, 8 more ticks run under
torch.cuda.set_sync_debug_mode("warn"), and the warnings (each a host
wait for the card: a blocking copy, .cpu(), .item(), a stream or device
synchronize) are counted by the line that made them. It passes no option
a version of the Engine without decode_inflight lacks, so a copy of this
file beside an older checkout counts that checkout's waits.

bounds: needs no card. The least time of the expert decode kernels at
the shapes the expert probes time (chip_smoke.bound: the larger of the
operations the routed pairs need over the bf16 peak and the bytes over
the memory rate, counting x, the rows' expert ids and token slots, the
distinct experts' weights and scales once, and the rows' bf16 outputs).

warps: copies of vita_tpu_torch/csrc under build/warps/, each with another
choice of warps per block in expert_ffn.cu, built together and held
against the plain versions, then timed on the same inputs (CUDA events,
median of 25 after 3 warm-ups, two passes in opposite orders): the gather
schedule at T 1 over int8 experts (B6) and over int4 experts with scales
in groups of 128, with bf16 activations at the serving width (D 4096, F
14336, 8 experts). bf16 experts, per-channel int4 experts and the masked
int8 schedule with bf16 activations run the tensor-core kernels of
csrc/expert_ffn_bf16.cu and csrc/expert_ffn_q.cu, not this one, so they
are not swept.

gmm: chip_smoke.py's slice through Generator (max_len 12288, gmm prefill)
on a prompt of 8500 tokens with one new token, under torch.profiler after
a warm-up, summarised as profile summarises.

train: chip_smoke.py's training slice (2 of 32 LLM layers, stage 2, gmm,
flash, remat, bf16) through make_train_step: after a warm-up step on each
batch, one step on the 9216-token text batch and one on the image+audio
batch of chip_smoke.SmokeData, each under torch.profiler, summarised as
profile summarises.

flash: B10 and B11 in bf16 (B 1, 32/8 heads of 128, causal) at S 4096 and
at the training step's 9216 bucket with 5735 real tokens, on B1's o and
lse: CUDA events, median of 25 after 3 warm-ups, and the rate of the
FLOPs the masks leave (3 products per (q, key) pair for dq, 4 for dk/dv).
It reads only the flash wrappers that every version of the port has, so
a copy of this file beside an older checkout times that checkout's
kernels in the same call.

gmm-kernels: B5a in bf16 at a 12288-token prompt bucket (R 28672, tile
512), gate/up and down, and as dx in a 9216-token training step (R 22528,
transpose_rhs), and B12 at that step's gate/up and down shapes: CUDA
events, median of 25 after 3 warm-ups, and the rate of 2 R K N FLOPs.
B12's line also gives the experts' rows and how evenly its persistent
walk deals their stages to 132 blocks. Like flash, it reads only wrappers
and chip_smoke helpers that every version since the training slice has,
so it times an older checkout's kernels from beside it.

gmm-tiles: copies of csrc/gmm.cu under build/gmm_tiles/, one per
GMM_TILE_CHOICES entry (ring stages, wgmma groups a consumer keeps in
flight, M tiles per group of the tile order of the bf16 wgmma + TMA
kernel), built together, held against the plain versions and timed as
warps times its choices, on gmm-kernels' five cases.

flash-fwd: B1 in bf16 (32/8 heads of 128, causal) at FLASH_FWD_CASES: an
Engine prefill chunk (256 rows over 512 keys), the training step's 9216
bucket with 5735 real tokens, the Generator's 12288-row prefill over 8500
keys and its decode row over them: CUDA events, median of 25 after 3
warm-ups, and the rate of the FLOPs the masks leave (2 products of 2 x
128 FLOP per (q row, key) pair). Like flash, it reads only wrappers that
every version has, so it times an older checkout's B1 from beside it.

flash-fwd-tiles: copies of csrc/flash_fwd.cu under build/flash_fwd_tiles/,
one per FLASH_FWD_CHOICES entry (K/V ring stages), held against the plain
version and timed as warps times its choices, on flash-fwd's cases.

gmm-small: B5b in bf16 at GMM_SMALL_CASES: the Engine's 256-token chunk
(R 1536, tile 128), gate/up and down, and the training steps of 1024 and
4096 tokens (R 3072 and 9216), gate/up, down and dx: CUDA events, median
of 25 after 3 warm-ups, the rate of 2 R K N FLOPs and the weight stream
(the distinct experts' weights over the kernel time). Reads only wrappers
every version has, as flash does.

gmm-small-order: copies of csrc/gmm.cu under build/gmm_small_order/, one
per ORDER_CHOICES entry: the bf16 kernel's tile order in the TPU kernel's
weights-once order (one group of all of R's M tiles) and in the shipped
groups of 16 M tiles. On gmm-small's cases both are held against the
plain version and against each other's bits, then timed in ORDER_ROUNDS
alternating rounds of one process (CUDA events, median of 25 after 3
warm-ups each; which goes first alternates): per case the median of each
and the median, least and largest of the paired ratios. At R 1536 (12 M
tiles) the two are the same walk, so its ratios show a pair's spread.

expert: bf16 B3 (gather_expert_ffn_cuda) at T 1 and 3 (T 3's pairs sorted
by expert, as the main path runs them) and B4 (masked_expert_ffn_cuda) at
T 4, 8 and 16, over 8 bf16 experts at the serving width (D 4096, F 14336,
top-2 routing from the seed), and B4 at phase 2's shape (T 4 over 5
distinct experts), held against the plain version, then timed:
CUDA events (median of 25 after 3 warm-ups), the device time of the
expert kernels per call and of each kernel per launch (torch.profiler over
10 calls), and the rate at which each streams the distinct experts'
weights, with its share of that bytes bound. Reads only the wrappers and
chip_smoke helpers every version since the first slice has, so it times
an older checkout's B3/B4 from beside it, as flash does.

expert-ring: copies of csrc/expert_ffn_bf16.cu under build/expert_ring/,
one per EXPERT_RING_CHOICES entry (ring stages of the up and down kernels,
k rows a stage, F rows a down block, output columns a block, the L2
prefetch hint of the weight copies), held against the plain version and
timed on expert's cases as warps times its choices, then the expert
kernels' device ms per call with each choice (10 calls under
torch.profiler, two passes in opposite orders).

expert-q4: B8b, the masked int4 expert FFN (masked_expert_ffn_q_cuda,
bits 4) in bf16 at the serving width (D 4096, F 14336, 8 experts, top-2
routing from the seed) at T 8 and T 16, held against the plain version,
then timed: CUDA events, median of 25 after 3 warm-ups, and the rate at
which it streams the distinct experts' bytes (packed weights and scales,
each read once); then each kernel's device time per launch under
torch.profiler over 10 calls. Reads only masked_expert_ffn_q_cuda and
_active_expert_plan, which every version since the quantized slice has, so
it times an older checkout's B8b from beside it, as flash does.

expert-q4-ring: copies of csrc/expert_ffn_q.cu under build/expert_q4_ring/,
one per Q4_RING_CHOICES entry (ring stages of the up and down kernels, F
rows per down block), held against the plain version and timed on
expert-q4's cases as warps times its choices, then profiled per kernel as
expert-q4 does.

expert-q: bf16 B7 and B6 (gather_expert_ffn_q_cuda over per-channel int4
and over int8 experts) at T 1 and 3 (T 3's pairs sorted by expert, as the
main path runs them) and B8a (masked_expert_ffn_q_cuda over int8 experts)
at T 4 over 5 distinct experts (phase 2's shape), 8 and 16, at the serving
width (D 4096, F 14336, 8 experts, top-2 routing from the seed), held against the
plain version, then timed as expert times bf16 B3/B4: CUDA events, the
expert kernels' device time per call and per launch (torch.profiler over
10 calls) and the share of the distinct experts' bytes bound (packed
weights and scales, each read once). Reads only gather_expert_ffn_q_cuda,
masked_expert_ffn_q_cuda, _active_expert_plan and the plain versions,
which every version since the quantized slice has, so it times an older
checkout's SIMT B6/B7/B8a from beside it, as flash does.

paged: B2 (bf16 pages of 64) and B9 (int8 pages of 128, bf16 q) at
PAGED_CASES: phase 2's slots (lengths 1000/37/0/2048), 8 slots of 4096
keys (the Engine's default max_len), and a served wave of 8 slots of 44-232
keys (profile's WAVE lengths plus 32 decoded tokens), 32 / 8 heads of
128, held against the plain version, then timed: CUDA events around one
call (median of 25 after 3 warm-ups, the wrapper's host work included),
and the kernel's device time (torch.profiler, median of 25 launches), each
with the rate at which it streams the used K/V rows (and int8 rows'
scales), q and o, and its share of the bytes bound. Reads only
paged_attention_cuda and chip_smoke's case builders, which every version
since the quantized slice has, so it times an older checkout's B2/B9 from
beside it, as flash does.

paged-ring: copies of csrc/paged_attn.cu under build/paged_ring/, one per
PAGED_CHOICES entry (the ring stages of the tensor-core path over bf16 and
over int8 pages), held against the plain version, then the kernel's device
time on paged's cases (torch.profiler, median of 25 launches) with each
choice, in two passes of opposite orders.

session: chip_smoke.py's full-width 4-layer slice on two bf16 Engines
(gather decode, prefill chunks of 256), both warmed up: in each of
SESSION_ROUNDS rounds a new session's text turn (300 ids, 16 new tokens)
on the reuse Engine, then its image+audio turn 2 (chip_smoke's
session_turns: 256 rows reused) on the reuse Engine and the same prompt
on the cold one, which goes first alternating by round. Prints each
round's TTFT pair and the medians, quartiles and the paired
differences, then one reused and one cold turn 2 under torch.profiler
(wall, device time, busy share, largest device entries).

whale: Whale at full width (24 x 1024, 16 heads of 64, bf16, random
weights from the seed) on one clip of 4, 30 and 120 s (400, 3000 and
12000 fbank frames): WHALE_ROUNDS rounds of a flash and an xla forward
in turns after a warm-up (CUDA events around each forward), then one
forward of each under torch.profiler (wall, device time, busy share,
largest device entries, the port's kernels).

mesh: chip_smoke.py's full-width 4-layer slice (bf16 experts, dense
prefill, gather decode) served by the unsharded Engine and, as 4 gloo
ranks on cuda:0, under the meshes expert x model 2 x 2, 1 x 4 and 4 x 1 on
phase 11's bf16 traffic: per mesh, the largest difference of each prefill
sample's logits and of each decode step's up to the request's first
differing token, and the first prompt row or decode step whose experts
the mesh chose otherwise, with the unsharded run's router gap there.

mesh-faults: chip_smoke.py's phase 11 (`mesh_phase`) run on a copy of the
tree under build/faults/ as it is, then with each MESH_FAULTS edit
planted in the copy (wo's partial sums rounded to bf16; the sum over
'model' of the output projection dropped; the expert partials left in
bf16): per run, each check's reading and the checks that failed.

ring: ring attention (parallel.ring_attention) at chip_smoke.py phase
12(a)'s shapes (32 q / 8 kv heads of 128, bf16, B 1, S 8192, causal) as 4
gloo ranks time-sharing cuda:0, under seq 4 and under seq 2 x model 2: on
the last rank (one B1, B10 and B11 a ring step), three forward + backward
passes under torch.profiler, each with its wall and device ms, the busy
share, the host ms inside the ring's point-to-point shifts and each device
entry's ms a launch; then the unsharded flash_mha forward + backward alone
on the card (CUDA events).

ring-faults: chip_smoke.py phase 12's (a) and (b) (`seq_phase_ab`) run
on a copy of the tree under build/faults/ as it is, then with each
SEQ_FAULTS edit planted in the copy (each rank's last ring step's dq
dropped; the last shift of dk/dv home dropped; aux's sums over 'seq'
summed in the backward too): per run, each check's reading and the
checks that failed.

pp: chip_smoke.py's full-width 4-layer slice (bf16 experts, 8 slots)
served unsharded on the card, then under --mesh 1 1 4 as 4 gloo ranks
time-sharing cuda:0 (the shards read from a bf16 export under
build/smoke_mesh/, removed after): after a warm-up wave, eight text
requests of 64 new tokens; the unsharded run and the last stage under
torch.profiler (wall, device ms, busy share), every rank's aggregate
tok/s, TTFT and the host ms of each decode-ring substep's shift.

pp-faults: chip_smoke.py phase 13's (a) and (c) (`pipe_phase` without the
full-width part) run on a copy of the tree under build/faults/ as it is,
then with each PIPE_FAULTS edit planted in the copy (the ring's wrap
carrying the last stage's hidden state instead of the new token's
embedding; the GPipe prefill's bubble steps computing on zeros and
writing KV rows; the GPipe backward sending zeros upstream in place of
dL/dx): per run, each check's reading and the checks that failed.

tp-faults: chip_smoke.py phase 15's (b) alone (`tp_phase_b`: the
unsharded full-width step and its float32 gradients here, then the slice
under TP_FULL_MESHES on 4 gloo ranks on cuda:0) run on a copy of the
tree under build/faults/ as it is, then with each TP_FAULTS edit planted
in the copy (the "f" over 'model' on the attention's input dropped; the
experts' ffn-column partials rounded to bf16 before their sum): per run,
each trainable leaf's sampled gradient against the unsharded bf16 step's
and both against the float32 gradient, then the checks that failed.

dp-serve: the full-width 2-layer slice (chip_smoke.py phase 14(d)'s
weights, traffic and Engine options) served by the Engine over --mesh
1 4 1 1, 4 gloo ranks time-sharing cuda:0, with bf16, int8 and int4
experts (gmm prefill; int8 KV pages beside the quantized experts): per
rank and engine, the host ms inside the fsdp gathers a prefill chunk and
a decode step, the quantized copy's gathers at the Engine's build, the
peak, TTFT and tok/s; rank 0 under torch.profiler for the device's busy
share over the served requests.

dp-faults: chip_smoke.py phase 14's capacity case of (a) (moe_chunk 40
under 1 2 1 1) and (d)'s int4 run with the int8 copy (`dp_phase_ad`) run
on a copy of the tree under build/faults/ as it is, then with each
DP_FAULTS edit planted in the copy (decode_params quantizing each rank's
own block of the experts instead of the gathered layer; the capacity
mode with moe_chunk run over each rank's own tokens): per run, each
check's reading and the checks that failed.

Each prints the card's name and power limit first.

"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import os
import re
import shutil
import sys
import time

import numpy as np

import chip_smoke as smoke

NEW_TOKENS = 64
WAVE = (100, 20, 150, 60, 33, 90, 12, 200)
ENGINES = (
    ("bf16 experts, bf16 KV pages",
     dict(n_slots=8, page_size=64, decode_moe_mode="gather", max_concurrent_prefills=8)),
    ("int4 experts, int8 KV pages",
     dict(n_slots=8, page_size=128, decode_moe_mode="gather_q4", kv_int8=True,
          max_concurrent_prefills=8)),
    ("int8 experts, int8 KV pages",
     dict(n_slots=8, page_size=128, decode_moe_mode="gather_q", kv_int8=True,
          max_concurrent_prefills=8)),
)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# name: (up warps, down warps), each a constant expression of the kernel's
# token slots NT; the shared-memory arrays bound warps * NT
WARP_CHOICES = {
    "8/8 everywhere (the first schedule)": ("8", "8"),
    "16/16 at NT <= 2": ("NT <= 2 ? 16 : 8", "NT <= 2 ? 16 : 8"),
    "16/32 at NT <= 2 (shipped)": ("NT <= 2 ? 16 : 8", "NT <= 2 ? 32 : 8"),
    "32/32 at NT <= 2": ("NT <= 2 ? 32 : 8", "NT <= 2 ? 32 : 8"),
    "8/32 at NT <= 2": ("8", "NT <= 2 ? 32 : 8"),
    "16/32 at NT <= 2, 16/16 at NT 4-8": ("NT <= 4 ? 16 : 8", "NT <= 2 ? 32 : NT <= 8 ? 16 : 8"),
}


def profile(card: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = smoke.slice_config()
    params = vita.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    for label, options in ENGINES:
        for depth in (1, 2):
            engine = Engine(params, cfg, max_len=2048, device=dev, decode_inflight=depth,
                            **options)
            for run, lengths in (("solo", WAVE[:1]), ("wave of 8 text", WAVE)):
                def traffic():
                    rng = np.random.default_rng(smoke.SEED)
                    return [smoke.text_request(cfg, rng, n, NEW_TOKENS) for n in lengths]

                smoke.serve(engine, traffic())
                torch.cuda.synchronize()
                with torch_profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    smoke.serve(engine, traffic())
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                _summarize(prof, wall, f"{label}, decode_inflight {depth}, {run}", card)
            del engine
            gc.collect()
            torch.cuda.empty_cache()


def syncs(card: str) -> None:
    import warnings

    import torch

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = smoke.slice_config()
    params = vita.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    label, options = ENGINES[0]
    engine = Engine(params, cfg, max_len=2048, device=dev, **options)
    rng = np.random.default_rng(smoke.SEED)
    smoke.serve(engine, [smoke.text_request(cfg, rng, 100, 8)])  # warm-up
    req = engine.submit(smoke.text_request(cfg, rng, 100, 512))
    while engine.active_count() == 0 or engine._prefill_jobs:
        engine.step()
    for _ in range(2):  # the chunks in flight, where there are any, fill up
        engine.step()
    ticks, sites = 8, collections.Counter()
    # set before the warnings are recorded: setting it warns once itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            for _ in range(ticks):
                engine.step()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for w in seen:
        if "synchronizing" in str(w.message):
            sites[f"{os.path.relpath(w.filename)}:{w.lineno}"] += 1
    n = sum(sites.values())
    print(f"  {label}, one request decoding alone: {ticks} ticks in {wall:.1f} ms, {n} host "
          f"waits for the card ({n / ticks:.2f} a tick)  [{card}]", flush=True)
    for site, k in sites.most_common():
        print(f"      {k:5d}  {site}", flush=True)
    req.cancel()
    engine.run_until_idle()


def bounds(_card: str = "") -> None:
    d, f, k = 4096, 14336, 2
    # (kernel, T, distinct experts, weight bits, masked plan)
    cases = (("B3", 3, 5, 16, False), ("B4", 8, 8, 16, True), ("B4", 16, 8, 16, True),
             ("B8a", 8, 6, 8, True), ("B8a", 16, 8, 8, True), ("B8b", 16, 8, 4, True))
    for name, t, n_exp, bits, masked in cases:
        expert = 3 * d * f * bits // 8 + (0 if bits == 16 else 4 * (2 * f + d))
        slots = 1 << (t - 1).bit_length()
        rows, nt = (n_exp, slots) if masked else (t * k, 1)
        nbytes = 2 * t * d + 4 * rows * (1 + nt) + n_exp * expert + 2 * rows * nt * d
        flops = 2 * 3 * d * f * t * k
        ms, by = smoke.bound(flops, nbytes)
        print(f"  {name} T {t:2d} over {n_exp} experts: bound {ms:.4f} ms ({by}: "
              f"{flops:.3e} FLOP, {nbytes:.4e} B)", flush=True)


def _summarize(prof, wall: float, label: str, card: str, top: int = 6) -> None:
    """Device time, busy share, host launches and the largest device
    entries of a profiled window of ``wall`` ms, then the port's own
    kernels (namespace vita) that are not among them."""
    from torch.autograd import DeviceType

    on_dev = collections.defaultdict(lambda: [0.0, 0])
    launches = [0, 0.0]
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if e.device_type == DeviceType.CUDA:
            on_dev[e.name][0] += us / 1e3
            on_dev[e.name][1] += 1
        elif e.name in LAUNCH_CALLS:
            launches[0] += 1
            launches[1] += us / 1e3
    dev_ms = sum(ms for ms, _ in on_dev.values())
    if dev_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"  {label}: wall {wall:.1f} ms, device {dev_ms:.1f} ms, busy "
          f"{dev_ms / wall:.3f}, host launches {launches[0]} ({launches[1]:.2f} ms)"
          f"  [{card}]", flush=True)
    ranked = sorted(on_dev.items(), key=lambda kv: -kv[1][0])
    for i, (name, (ms, n)) in enumerate(ranked):
        if i < top or "vita::" in name:
            print(f"      {ms:9.2f} ms {n:6d} calls  {_short(name)}", flush=True)


def _short(name: str) -> str:
    """A kernel's name without its parameter list and namespaces."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    return name.replace("void ", "").replace("vita::", "")[:110]


def _build_choices(root, source: str, choices):
    """One library per choice under ``root``: the other sources compiled
    once, ``source`` once per choice, all at once. A choice maps names to
    values: each `constexpr int name() { return ...; }` or `constexpr int
    name = ...;` of the source gets that value."""
    from vita_tpu_torch import kernels

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    nvcc = kernels._nvcc()
    stem = source.rsplit(".", 1)[0]
    text = (kernels.CSRC / source).read_text()
    others = [s for s in sorted(kernels.CSRC.glob("*.cu")) if s.name != source]
    cmds = [[nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(root / f"{s.stem}.o"), str(s)]
            for s in others]
    dirs = []
    for i, choice in enumerate(choices):
        d = root / f"choice{i}"
        d.mkdir()
        for h in kernels.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        src = text
        for name, value in choice.items():
            src, n = re.subn(rf"(constexpr int {name}(?:\(\) {{ return | = ))[^;]*(;)",
                             rf"\g<1>{value}\g<2>", src)
            if n != 1:
                raise RuntimeError(f"{source} has no single constexpr {name} to replace")
        (d / source).write_text(src)
        cmds.append([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(d / f"{stem}.o"),
                     str(d / source)])
        dirs.append(d)
    kernels._run_all(cmds)
    kernels._run_all([[nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                       str(d / f"{stem}.o"), *(str(root / f"{s.stem}.o") for s in others)]
                      for d in dirs])
    libs = []
    for d in dirs:
        handle = ctypes.CDLL(str(d / "lib.so"))
        for name, argtypes in kernels._SIGNATURES.items():
            getattr(handle, name).argtypes = argtypes
            getattr(handle, name).restype = ctypes.c_int
        libs.append(handle)
    return libs


def warps(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.ops import moe_decode as md

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "warps", "expert_ffn.cu",
                          [{"up_warps": up, "down_warps": down}
                           for up, down in WARP_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(smoke.SEED)
    d, f = 4096, 14336
    wg, wu, wd = smoke._expert_weights(rng, 8, d, f, bf16, dev)
    stack = {"router": wg.new_zeros(d, 8), "w_gate": wg, "w_up": wu, "w_down": wd}
    q8, q4g = md.quantize_expert_weights(stack), md.quantize_expert_weights_int4(stack, 128)
    del wg, wu, wd, stack
    cases = []  # (label, kernel, plain)
    for fmt, qp, b in (("int8", q8, 8), ("int4 group 128", q4g, 4)):
        x1 = torch.from_numpy(rng.standard_normal((1, d), np.float32)).to(dev, bf16)
        _, i1 = smoke._routing(rng, 1, 2, 8, 0, bf16, dev)
        cases.append((f"{fmt} gather T=1",
                      lambda x=x1, i=i1, q=qp, b=b: md.gather_expert_ffn_q_cuda(x, i, q, b),
                      lambda x=x1, i=i1, q=qp, b=b: md.gather_expert_ffn_q_plain(x, i, q, b)))
    _sweep(card, list(WARP_CHOICES), libs, cases, "up/down warps")


def _sweep(card: str, names, libs, cases, what: str) -> None:
    """Each case (label, kernel, plain) with each library against its plain
    version (bf16 tolerance), then timed with each library in two passes
    of opposite orders."""
    from vita_tpu_torch import kernels

    ms = {(c, n): [] for c, _, _ in cases for n in names}
    for label, run, plain in cases:
        want = plain()
        for n, lib in zip(names, libs):
            kernels._lib = lib
            smoke.compare(f"{label} with {n}", run(), want, 2e-2, 2e-2)
        del want
    for order in (range(len(names)), reversed(range(len(names)))):
        for k in order:
            kernels._lib = libs[k]
            for label, run, _ in cases:
                ms[(label, names[k])].append(smoke.cuda_ms(run))
    kernels._lib = None
    print(f"  kernel ms per choice ({what}), passes in opposite orders  [{card}]")
    for label, _, _ in cases:
        print(f"    {label}", flush=True)
        for n in names:
            a, b = ms[(label, n)]
            print(f"      {n:44s} {a:.4f}  {b:.4f}", flush=True)


# name: csrc/gmm.cu's (kWgStages, kWgInFlight, kWgGroupM) of the bf16
# wgmma + TMA kernel: ring stages, wgmma groups a consumer keeps in flight,
# M tiles per group of the tile order
GMM_TILE_CHOICES = {
    "4 stages, 0 in flight, group 16 (shipped)": (4, 0, 16),
    "3 stages, 0 in flight, group 16": (3, 0, 16),
    "4 stages, 1 in flight, group 16": (4, 1, 16),
    "3 stages, 1 in flight, group 16": (3, 1, 16),
    "4 stages, 0 in flight, group 8": (4, 0, 8),
    "4 stages, 0 in flight, group 32": (4, 0, 32),
    "4 stages, 1 in flight, group 8": (4, 1, 8),
    "4 stages, 1 in flight, group 32": (4, 1, 32),
}


def gmm_tiles(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.ops import moe_gmm as mg

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "gmm_tiles", "gmm.cu",
                          [dict(zip(("kWgStages", "kWgInFlight", "kWgGroupM"), v))
                           for v in GMM_TILE_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(smoke.SEED)
    cases = []
    for label, t, down, trans in (("B5a gate/up R 28672", 12288, False, False),
                                  ("B5a down R 28672", 12288, True, False),
                                  ("B5a dx R 22528", 9216, True, True)):
        x, w, gids, tile_m = smoke._gmm_case(rng, t, 4096, 14336, 8, bf16, dev, down)
        if trans:
            w = w.transpose(1, 2).contiguous()
        args = (x, w, gids, trans, tile_m)
        cases.append((label, lambda a=args: mg.gmm_cuda(*a), lambda a=args: mg.gmm_plain(*a)))
    for label, down in (("B12 gate/up R 22528", False), ("B12 down R 22528", True)):
        a, b, gids, tile_m = smoke._wgrad_case(rng, 9216, 4096, 14336, 8, bf16, dev, down)
        args = (a, b, gids, 8, tile_m)
        cases.append((label, lambda a=args: mg.gmm_wgrad_cuda(*a),
                      lambda a=args: mg.gmm_wgrad_plain(*a)))
    _sweep(card, list(GMM_TILE_CHOICES), libs, cases, "stages, wgmma groups in flight, group")


# (label, Sq, Skv, kv_len, q_offset) of B1 in bf16, 32/8 heads, causal
FLASH_FWD_CASES = (
    ("chunk 256 over 512, offset 256", 256, 512, 512, 256),
    ("train bucket 9216, kv_len 5735", 9216, 9216, 5735, 0),
    ("prefill 12288 over kv_len 8500", 12288, 12288, 8500, 0),
    ("decode row over kv_len 8500", 1, 12288, 8500, 8499),
)
# name: csrc/flash_fwd.cu's kKvStages
FLASH_FWD_CHOICES = {"2 stages (shipped)": 2, "3 stages": 3}
# (label, tokens, down, transpose_rhs) of B5b in bf16 at D 4096, F 14336,
# 8 experts, top-2, tile 128
GMM_SMALL_CASES = (
    ("R 1536 gate/up", 256, False, False),
    ("R 1536 down", 256, True, False),
    ("R 3072 gate/up", 1024, False, False),
    ("R 3072 down", 1024, True, False),
    ("R 3072 dx", 1024, True, True),
    ("R 9216 gate/up", 4096, False, False),
    ("R 9216 down", 4096, True, False),
    ("R 9216 dx", 4096, True, True),
)
# name: csrc/gmm.cu's kWgGroupM, M tiles per group of the bf16 kernel's
# tile order (more than any R has: one group, the weights-once order)
ORDER_CHOICES = {"weights-once": 1 << 20, "groups of 16 (shipped)": 16}
ORDER_ROUNDS = 10


def _flash_fwd_cases(rng, dev):
    """(label, kernel, plain, FLOPs) per FLASH_FWD_CASES entry; the plain
    version runs one GQA group at a time past 4096 rows."""
    import torch

    from vita_tpu_torch.ops import flash_attention as fa

    out = []
    for label, sq, skv, kv_len, q_off in FLASH_FWD_CASES:
        args = smoke._flash_case(rng, 1, sq, skv, 32, 8, [kv_len], [q_off], torch.bfloat16,
                                 dev)
        plain = smoke._by_group(fa.flash_fwd_plain, (2, 1)) if sq > 4096 else fa.flash_fwd_plain
        flops = 4 * smoke.attn_pairs(sq, [kv_len], [q_off], True) * 128 * 32
        out.append((label, lambda a=args: fa.flash_fwd_cuda(*a)[0],
                    lambda a=args, f=plain: f(*a)[0], flops))
    return out


def flash_fwd(card: str) -> None:
    import torch

    dev = torch.device("cuda")
    for label, run, _, flops in _flash_fwd_cases(np.random.default_rng(smoke.SEED), dev):
        ms = smoke.cuda_ms(run)
        print(f"  B1 bf16 B=1 32/8 heads {label:32s}: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
              f"TFLOP/s  [{card}]", flush=True)


def flash_fwd_tiles(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "flash_fwd_tiles", "flash_fwd.cu",
                          [{"kKvStages": v} for v in FLASH_FWD_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    cases = [c[:3] for c in _flash_fwd_cases(np.random.default_rng(smoke.SEED),
                                            torch.device("cuda"))]
    _sweep(card, list(FLASH_FWD_CHOICES), libs, cases, "K/V stages")


def _gmm_small_cases(rng, dev):
    """(label, kernel, plain, FLOPs, weight bytes the call must read) per
    GMM_SMALL_CASES entry."""
    import torch

    from vita_tpu_torch.ops import moe_gmm as mg

    out = []
    for label, t, down, trans in GMM_SMALL_CASES:
        x, w, gids, tile_m = smoke._gmm_case(rng, t, 4096, 14336, 8, torch.bfloat16, dev, down)
        if trans:  # the down-shaped [E, F, D] as the gate/up weight [E, D, F]
            w = w.transpose(1, 2).contiguous()
        r, k = x.shape
        n = w.shape[1 if trans else 2]
        used = len(torch.unique(gids))
        out.append((label, lambda a=(x, w, gids, trans, tile_m): mg.gmm_cuda(*a),
                    lambda a=(x, w, gids, trans, tile_m): mg.gmm_plain(*a),
                    2 * r * k * n, used * k * n * w.element_size()))
    return out


def gmm_small(card: str) -> None:
    import torch

    dev = torch.device("cuda")
    for label, run, _, flops, wbytes in _gmm_small_cases(np.random.default_rng(smoke.SEED), dev):
        ms = smoke.cuda_ms(run)
        print(f"  B5b bf16 {label:16s}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, weights "
              f"{wbytes / ms / 1e9:.3f} TB/s  [{card}]", flush=True)


def gmm_small_order(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "gmm_small_order", "gmm.cu",
                          [{"kWgGroupM": g} for g in ORDER_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    once, g16 = libs
    print(f"  B5b bf16 ms, weights-once order vs groups of 16 M tiles, {ORDER_ROUNDS} "
          f"alternating rounds  [{card}]", flush=True)
    for label, run, plain, _, _ in _gmm_small_cases(np.random.default_rng(smoke.SEED),
                                                    torch.device("cuda")):
        want = plain()
        outs = []
        for name, lib in zip(ORDER_CHOICES, libs):
            kernels._lib = lib
            outs.append(run())
            smoke.compare(f"{label} {name}", outs[-1], want, 2e-2, 2e-2)
        if not smoke._same_bits(*outs):
            raise AssertionError(f"{label}: the two tile orders differ in bits")
        del want, outs
        ms = {once: [], g16: []}
        for i in range(ORDER_ROUNDS):
            for lib in ((once, g16) if i % 2 == 0 else (g16, once)):
                kernels._lib = lib
                ms[lib].append(smoke.cuda_ms(run))
        kernels._lib = None
        ratio = np.array(ms[once]) / np.array(ms[g16])
        print(f"    {label:16s}: weights-once {np.median(ms[once]):.4f}, groups of 16 "
              f"{np.median(ms[g16]):.4f}; ratio median {np.median(ratio):.4f}, range "
              f"{ratio.min():.4f}-{ratio.max():.4f}", flush=True)


# name: csrc/expert_ffn_bf16.cu's (kUpStages, kDownStages, kRows,
# kDownSplitRows, kCols, kL2Prefetch): ring stages of up and down, k rows a
# stage, F rows a down block, output columns a block, L2 prefetch hint of
# the weight copies (bytes)
EXPERT_RING_NAMES = ("kUpStages", "kDownStages", "kRows", "kDownSplitRows", "kCols",
                     "kL2Prefetch")
EXPERT_RING_CHOICES = {
    "3 / 3 stages of 64 rows, 2048 F rows a down block, 128 columns, L2 prefetch 256 B "
    "(shipped)": (3, 3, 64, 2048, 128, 256),
    "4 / 4 stages of 32 rows, 2048, 128 (the first kernel's)": (4, 4, 32, 2048, 128, 0),
    "6 / 6 stages of 32 rows, 2048, 128": (6, 6, 32, 2048, 128, 0),
    "3 / 3 stages of 64 rows, 2048, 128": (3, 3, 64, 2048, 128, 0),
    "8 / 8 stages of 16 rows, 2048, 128": (8, 8, 16, 2048, 128, 0),
    "4 / 4 stages of 32 rows, 1024, 128": (4, 4, 32, 1024, 128, 0),
    "4 / 6 stages of 32 rows, 4096, 128": (4, 6, 32, 4096, 128, 0),
    "4 / 4 stages of 32 rows, 2048, 64": (4, 4, 32, 2048, 64, 0),
    "6 / 8 stages of 32 rows, 2048, 64": (6, 8, 32, 2048, 64, 0),
    "4 / 4 stages of 32 rows, 2048, 128, L2 prefetch 128 B": (4, 4, 32, 2048, 128, 128),
    "4 / 4 stages of 32 rows, 2048, 128, L2 prefetch 256 B": (4, 4, 32, 2048, 128, 256),
}


# name: csrc/expert_ffn_q.cu's (kUpStages, kDownStages, kDownSplitRows)
Q4_RING_CHOICES = {
    "up 3 / down 4 stages, 2048 F rows a down block (shipped)": (3, 4, 2048),
    "up 4 / down 6 stages, 2048 F rows a down block": (4, 6, 2048),
    "up 3 / down 4 stages, 1024 F rows a down block": (3, 4, 1024),
}


def _device_times(run, n: int = 10):
    """{kernel: [device ms of each launch]} of n calls of ``run`` under
    torch.profiler, after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    per = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[_short(e.name)[:40]].append(e.time_range.elapsed_us() / 1e3)
    return per


def _kernel_breakdown(per) -> str:
    """Each kernel of a _device_times record: device ms per launch and the
    launches recorded."""
    return ", ".join(f"{k} {np.mean(v):.4f} ({len(v)})"
                     for k, v in sorted(per.items(), key=lambda kv: -sum(kv[1])))


def _expert_device_ms(per) -> float:
    """Device ms per call of the expert FFN kernels (up, down, finish) in
    _device_times' record of 10 calls."""
    return sum(sum(v) for k, v in per.items() if re.search(r"_(up|down|finish)_kernel", k)) / 10


def _expert_cases(rng, dev):
    """(label, kernel, plain, distinct experts' bytes) of bf16 B3 at T 1
    and 3 and B4 at T 4, 8 and 16 over 8 experts at the serving width, and
    B4 at phase 2's shape: T 4 routed over 5 distinct experts (the routing
    drawn again from the seed until it selects 5)."""
    import torch

    from vita_tpu_torch.ops import moe_decode as md

    d, f, bf16 = 4096, 14336, torch.bfloat16
    wg, wu, wd = smoke._expert_weights(rng, 8, d, f, bf16, dev)

    def gather(xr, ir):
        return md.gather_expert_ffn_cuda(xr, ir, wg, wu, wd)

    out = []
    for t, want_exp in ((1, None), (3, None), (4, None), (4, 5), (8, None), (16, None)):
        x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, bf16)
        w, idx = smoke._routing(rng, t, 2, 8, 0, bf16, dev)
        while want_exp is not None and len(torch.unique(idx)) != want_exp:
            w, idx = smoke._routing(rng, t, 2, 8, 0, bf16, dev)
        n_exp = len(torch.unique(idx))
        if t < 4:  # the pairs sorted by expert at T 2-3, as masked_expert_ffn runs them
            run = ((lambda x=x, i=idx: gather(x, i)) if t == 1 else
                   (lambda x=x, i=idx: md._sorted_pair_gather(x, i, gather)))
            out.append((f"B3 T={t:2d}, {2 * t} rows over {n_exp} experts", run,
                        lambda x=x, i=idx: md.gather_expert_ffn_plain(x, i, wg, wu, wd),
                        n_exp * 3 * d * f * 2))
            continue
        act, m = md._active_expert_plan(w, idx, 8)
        out.append((f"B4 T={t:2d}, {len(act)} plan rows over {n_exp} experts",
                    lambda x=x, a=act, m=m: md.masked_expert_ffn_cuda(x, a, m, wg, wu, wd),
                    lambda x=x, a=act, m=m: md.masked_expert_ffn_plain(x, a, m, wg, wu, wd),
                    n_exp * 3 * d * f * 2))
    return out


def _expert_report(card: str, cases) -> None:
    for label, run, plain, nbytes in cases:
        err = smoke.compare(label, run(), plain(), 2e-2, 2e-2)
        ms = smoke.cuda_ms(run)
        per = _device_times(run)
        dev_ms = _expert_device_ms(per)
        bound_ms = nbytes / smoke.PEAK_BYTES_PER_S * 1e3
        print(f"  {label} ({nbytes:.4g} B, bound {bound_ms:.4f} ms): {ms:.4f} ms, "
              f"{nbytes / ms / 1e9:.3f} TB/s, {bound_ms / ms:.3f} of the bound; device "
              f"{dev_ms:.4f} ms, {nbytes / dev_ms / 1e9:.3f} TB/s, {bound_ms / dev_ms:.3f}; "
              f"max abs err {err:.3e}  [{card}]", flush=True)
        print(f"    device ms per launch (launches): {_kernel_breakdown(per)}", flush=True)


def expert(card: str) -> None:
    import torch

    _expert_report(card, _expert_cases(np.random.default_rng(smoke.SEED), torch.device("cuda")))


def expert_ring(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "expert_ring", "expert_ffn_bf16.cu",
                          [dict(zip(EXPERT_RING_NAMES, v)) for v in EXPERT_RING_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    cases = _expert_cases(np.random.default_rng(smoke.SEED), torch.device("cuda"))
    _sweep(card, list(EXPERT_RING_CHOICES), libs, [c[:3] for c in cases], "bf16 B3/B4 ring")
    print(f"  expert kernels' device ms per call (10 calls), passes in opposite orders  [{card}]")
    ms = collections.defaultdict(list)
    for order in (range(len(libs)), reversed(range(len(libs)))):
        for k in order:
            kernels._lib = libs[k]
            for label, run, _, _ in cases:
                ms[(label, k)].append(_expert_device_ms(_device_times(run)))
    kernels._lib = None
    for label, _, _, nbytes in cases:
        print(f"    {label} ({nbytes:.4g} B)", flush=True)
        for k, name in enumerate(EXPERT_RING_CHOICES):
            a, b = ms[(label, k)]
            print(f"      {name:70s} {a:.4f}  {b:.4f}  ({nbytes / min(a, b) / 1e9:.3f} TB/s)",
                  flush=True)


def _expert_q4_cases(rng, dev):
    """(label, kernel, plain, distinct experts' bytes) at T 8 and 16 over
    int4 experts at the serving width."""
    import torch

    from vita_tpu_torch.ops import moe_decode as md

    d, f = 4096, 14336
    wg, wu, wd = smoke._expert_weights(rng, 8, d, f, torch.bfloat16, dev)
    qp = md.quantize_expert_weights_int4(
        {"router": wg.new_zeros(d, 8), "w_gate": wg, "w_up": wu, "w_down": wd})
    del wg, wu, wd
    torch.cuda.empty_cache()
    # bytes of one expert: packed gate, up and down, and their float32 scales
    per_expert = 3 * d * f // 2 + 4 * (2 * f + d)
    out = []
    for t in (8, 16):
        x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, torch.bfloat16)
        w, idx = smoke._routing(rng, t, 2, 8, 0, torch.bfloat16, dev)
        act, m = md._active_expert_plan(w, idx, 8)
        n_exp = len(torch.unique(idx))
        out.append((f"T={t:2d} over {n_exp} experts",
                    lambda x=x, a=act, m=m: md.masked_expert_ffn_q_cuda(x, a, m, qp, 4),
                    lambda x=x, a=act, m=m: md.masked_expert_ffn_q_plain(x, a, m, qp, 4),
                    n_exp * per_expert))
    return out


def expert_q4_ring(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "expert_q4_ring", "expert_ffn_q.cu",
                          [dict(zip(("kUpStages", "kDownStages", "kDownSplitRows"), v))
                           for v in Q4_RING_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    cases = _expert_q4_cases(np.random.default_rng(smoke.SEED), torch.device("cuda"))
    _sweep(card, list(Q4_RING_CHOICES), libs, [c[:3] for c in cases], "B8b ring and split")
    for name, lib in zip(Q4_RING_CHOICES, libs):
        kernels._lib = lib
        for label, run, _, _ in cases:
            print(f"    {name}, {label}: {_kernel_breakdown(_device_times(run))}", flush=True)
    kernels._lib = None


def expert_q4(card: str) -> None:
    import torch

    for label, run, plain, nbytes in _expert_q4_cases(np.random.default_rng(smoke.SEED),
                                                      torch.device("cuda")):
        smoke.compare(f"B8b {label}", run(), plain(), 2e-2, 2e-2)
        ms = smoke.cuda_ms(run)
        bound_ms = nbytes / smoke.PEAK_BYTES_PER_S * 1e3
        print(f"  B8b bf16 {label} ({nbytes:.4g} B): {ms:.4f} ms, {nbytes / ms / 1e9:.3f} TB/s, "
              f"{bound_ms / ms:.3f} of the bytes bound ({bound_ms:.4f} ms)  [{card}]", flush=True)
        print(f"    device ms per launch (launches): {_kernel_breakdown(_device_times(run))}",
              flush=True)


def _expert_q_cases(rng, dev):
    """(label, kernel, plain, distinct experts' bytes) of bf16 B7 at T 1 and
    3 over per-channel int4 experts, B6 at T 1 and 3 over int8 experts, and
    B8a at T 4 over 5 distinct experts
    (the routing drawn again from the seed until it selects 5), 8 and 16
    over int8 experts, at the serving width."""
    import torch

    from vita_tpu_torch.ops import moe_decode as md

    d, f, bf16 = 4096, 14336, torch.bfloat16
    wg, wu, wd = smoke._expert_weights(rng, 8, d, f, bf16, dev)
    stack = {"router": wg.new_zeros(d, 8), "w_gate": wg, "w_up": wu, "w_down": wd}
    qps = {4: md.quantize_expert_weights_int4(stack), 8: md.quantize_expert_weights(stack)}
    del wg, wu, wd, stack
    torch.cuda.empty_cache()

    def sorted_pairs(x, idx, bits):
        """B6/B7 over the pairs sorted by expert (as _sorted_pair_gather runs
        them), through gather_expert_ffn_q_cuda alone."""
        t, k = idx.shape
        order = torch.argsort(idx.reshape(-1), stable=True)
        out = md.gather_expert_ffn_q_cuda(x.repeat_interleave(k, dim=0)[order],
                                          idx.reshape(-1)[order][:, None], qps[bits], bits)
        return out.reshape(t * k, d)[torch.argsort(order)].reshape(t, k, d)

    out = []
    for bits, t, want_exp in ((4, 1, None), (4, 3, None), (8, 1, None), (8, 3, None),
                              (8, 4, 5), (8, 8, None), (8, 16, None)):
        qp = qps[bits]
        x = torch.from_numpy(rng.standard_normal((t, d), np.float32)).to(dev, bf16)
        w, idx = smoke._routing(rng, t, 2, 8, 0, bf16, dev)
        while want_exp is not None and len(torch.unique(idx)) != want_exp:
            w, idx = smoke._routing(rng, t, 2, 8, 0, bf16, dev)
        n_exp = len(torch.unique(idx))
        # packed weights and their float32 scales, each distinct expert once
        nbytes = n_exp * (3 * d * f * bits // 8 + 4 * (2 * f + d))
        if t < 4:
            run = ((lambda x=x, i=idx, q=qp, b=bits: md.gather_expert_ffn_q_cuda(x, i, q, b))
                   if t == 1 else (lambda x=x, i=idx, b=bits: sorted_pairs(x, i, b)))
            name = "B7 int4" if bits == 4 else "B6 int8"
            out.append((f"{name} T={t:2d}, {2 * t} rows over {n_exp} experts", run,
                        lambda x=x, i=idx, q=qp, b=bits: md.gather_expert_ffn_q_plain(x, i, q, b),
                        nbytes))
            continue
        act, m = md._active_expert_plan(w, idx, 8)
        out.append((f"B8a int8 T={t:2d}, {len(act)} plan rows over {n_exp} experts",
                    lambda x=x, a=act, m=m, q=qp: md.masked_expert_ffn_q_cuda(x, a, m, q, 8),
                    lambda x=x, a=act, m=m, q=qp: md.masked_expert_ffn_q_plain(x, a, m, q, 8),
                    nbytes))
    return out


def expert_q(card: str) -> None:
    import torch

    _expert_report(card, _expert_q_cases(np.random.default_rng(smoke.SEED),
                                         torch.device("cuda")))


# (label, int8 pages, lengths, page, table entries)
_SERVED = [n + 32 for n in WAVE]
PAGED_CASES = (
    ("B2 B=4 1000/37/0/2048, page 64", False, [1000, 37, 0, 2048], 64, 32),
    ("B2 B=8 x 4096, page 64", False, [4096] * 8, 64, 64),
    ("B2 B=8 served wave, page 64", False, _SERVED, 64, 32),
    ("B9 B=4 1000/37/0/2048, page 128", True, [1000, 37, 0, 2048], 128, 16),
    ("B9 B=8 x 4096, page 128", True, [4096] * 8, 128, 32),
    ("B9 B=8 served wave, page 128", True, _SERVED, 128, 16),
)
# name: csrc/paged_attn.cu's (kMmaStages, kMmaStagesQ), the ring stages of
# the tensor-core path over bf16 and int8 pages
PAGED_CHOICES = {
    "bf16 2 / int8 2 stages": (2, 2),
    "bf16 3 / int8 4 stages": (3, 4),
    "bf16 2 / int8 4 stages": (2, 4),
}


def _paged_cases(rng, dev):
    """(label, kernel, plain, bytes) for PAGED_CASES; one pool layer, the
    used rows read once, q read and o written."""
    import torch

    from vita_tpu_torch.ops import paged_attention as pa

    out = []
    for label, quant, lengths, page, max_pages in PAGED_CASES:
        n_pool = sum(-(-n // page) for n in lengths) + 2
        make = smoke._paged_q_case if quant else smoke._paged_case
        args = make(rng, lengths, 32, 8, 1, n_pool, page, max_pages, torch.bfloat16, dev)
        n, b = sum(lengths), len(lengths)
        row = 128 + 4 if quant else 128 * 2
        nbytes = 2 * n * 8 * row + 2 * b * 32 * 128 * 2
        out.append((label, lambda a=args: pa.paged_attention_cuda(*a),
                    lambda a=args: pa.paged_attention_plain(*a), nbytes))
    return out


def _paged_device_ms(run) -> float:
    """Median device ms of the paged kernel's launches in _device_times."""
    per = _device_times(run, 25)
    return float(np.median([ms for k, v in per.items() if "paged_attn" in k for ms in v]))


def paged(card: str) -> None:
    import torch

    for label, run, plain, nbytes in _paged_cases(np.random.default_rng(smoke.SEED),
                                                  torch.device("cuda")):
        err = smoke.compare(label, run(), plain(), 2e-2, 2e-2)
        ms, dev_ms = smoke.cuda_ms(run), _paged_device_ms(run)
        bound_ms = nbytes / smoke.PEAK_BYTES_PER_S * 1e3
        print(f"  {label:34s} ({nbytes:.4g} B): {ms:.4f} ms, {nbytes / ms / 1e9:.3f} TB/s, "
              f"{bound_ms / ms:.3f} of the bytes bound ({bound_ms:.4f} ms); device "
              f"{dev_ms:.4f} ms, {nbytes / dev_ms / 1e9:.3f} TB/s, {bound_ms / dev_ms:.3f}; "
              f"max abs err {err:.3e}  [{card}]", flush=True)


def paged_ring(card: str) -> None:
    import torch

    from vita_tpu_torch import kernels

    t0 = time.time()
    libs = _build_choices(kernels.BUILD_DIR.parent / "paged_ring", "paged_attn.cu",
                          [dict(zip(("kMmaStages", "kMmaStagesQ"), v))
                           for v in PAGED_CHOICES.values()])
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    cases = _paged_cases(np.random.default_rng(smoke.SEED), torch.device("cuda"))
    for label, run, plain, _ in cases:
        want = plain()
        for name, lib in zip(PAGED_CHOICES, libs):
            kernels._lib = lib
            smoke.compare(f"{label} with {name}", run(), want, 2e-2, 2e-2)
    print(f"  device ms per launch (median of 25), passes in opposite orders  [{card}]")
    ms = collections.defaultdict(list)
    for order in (range(len(libs)), reversed(range(len(libs)))):
        for k in order:
            kernels._lib = libs[k]
            for label, run, _, _ in cases:
                ms[(label, k)].append(_paged_device_ms(run))
    kernels._lib = None
    for label, _, _, nbytes in cases:
        print(f"    {label} ({nbytes:.4g} B)", flush=True)
        for k, name in enumerate(PAGED_CHOICES):
            a, b = ms[(label, k)]
            print(f"      {name:34s} {a:.4f}  {b:.4f}  ({nbytes / min(a, b) / 1e9:.3f} TB/s)",
                  flush=True)


def gmm(card: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.generate import GenerationConfig, Generator
    from vita_tpu_torch.models import vita

    dev = torch.device("cuda")
    rng = np.random.default_rng(smoke.SEED)
    cfg = smoke.slice_config()
    params = vita.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    gen = Generator(params, cfg, max_len=12288, prefill_moe_mode="gmm",
                    decode_moe_mode="gather", device=dev)
    ids = rng.integers(3, cfg.llm.vocab_size, 8500).astype(np.int32)
    one = GenerationConfig(max_new_tokens=1, eos_id=-1)
    gen.generate(ids, gen=one)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(ids, gen=one)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _summarize(prof, wall, "Generator, 8500-token prompt, gmm prefill + one decode chunk",
               card, top=10)


def train(card: str) -> None:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.data.dataset import Collator
    from vita_tpu_torch.models import vita
    from vita_tpu_torch.train import step

    dev = torch.device("cuda")
    cfg = smoke.train_slice_config()
    params = vita.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    data = smoke.SmokeData(cfg, smoke.TRAIN_DIR)
    tc = dataclasses.replace(step.TrainConfig.stage2_finetune(), warmup_steps=1)
    opt = step.make_optimizer(tc, params)
    state = opt.init(params)
    fn = step.make_train_step(cfg, tc, opt)
    collate = Collator(pad_id=0)
    longest = max(range(len(data) - 1), key=lambda j: len(data[j]["input_ids"]))
    for label, i in (("longest text batch", longest), ("image+audio batch", len(data) - 1)):
        batch = collate([data[i]])
        fn(params, state, batch)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(params, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _summarize(prof, wall, f"train step, {label} (bucket {batch['input_ids'].shape[1]})",
                   card, top=20)


def flash(card: str) -> None:
    import torch

    from vita_tpu_torch.ops import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(smoke.SEED)
    for label, s, kv_len in (("S 4096", 4096, 4096), ("S 9216 kv_len 5735", 9216, 5735)):
        q, k, v, kl, qo, causal, scale = smoke._flash_case(rng, 1, s, s, 32, 8, [kv_len], [0],
                                                           bf16, dev)
        do = torch.from_numpy(rng.standard_normal(q.shape, np.float32)).to(dev, bf16)
        o, lse = fa.flash_fwd_cuda(q, k, v, kl, qo, causal, scale)
        args = (q, k, v, do, lse, fa.flash_delta(do, o), kl, qo, causal, scale)
        pairs = smoke.attn_pairs(s, [kv_len], [0], causal)
        for name, fn, products in (("B10 dq", fa.flash_bwd_dq_cuda, 3),
                                   ("B11 dk/dv", fa.flash_bwd_dkv_cuda, 4)):
            ms = smoke.cuda_ms(lambda f=fn: f(*args))
            flops = 2 * products * pairs * 128 * q.shape[2]
            print(f"  {name:9s} bf16 B=1 {label:18s} causal: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s  [{card}]", flush=True)
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()


def gmm_kernels(card: str) -> None:
    import torch

    from vita_tpu_torch.ops import moe_gmm as mg

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(smoke.SEED)
    for label, t, down, trans in (("B5a gate/up", 12288, False, False),
                                  ("B5a down", 12288, True, False),
                                  ("B5a dx (transpose_rhs)", 9216, True, True)):
        x, w, gids, tile_m = smoke._gmm_case(rng, t, 4096, 14336, 8, bf16, dev, down)
        if trans:  # the down-shaped [E, F, D] as the gate/up weight [E, D, F]
            w = w.transpose(1, 2).contiguous()
        n = w.shape[1 if trans else 2]
        ms = smoke.cuda_ms(lambda: mg.gmm_cuda(x, w, gids, trans, tile_m))
        flops = 2 * x.shape[0] * x.shape[1] * n
        print(f"  {label:24s} R {x.shape[0]:5d} K {x.shape[1]:5d} N {n:5d}: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s  [{card}]", flush=True)
        del x, w
        torch.cuda.empty_cache()
    for label, down in (("B12 gate/up", False), ("B12 down", True)):
        a, b, gids, tile_m = smoke._wgrad_case(rng, 9216, 4096, 14336, 8, bf16, dev, down)
        ms = smoke.cuda_ms(lambda: mg.gmm_wgrad_cuda(a, b, gids, 8, tile_m))
        r, k, n = a.shape[0], a.shape[1], b.shape[1]
        print(f"  {label:24s} R {r:5d} K {k:5d} N {n:5d}: {ms:.4f} ms, "
              f"{2 * r * k * n / ms / 1e9:.1f} TFLOP/s; {_wgrad_walk(gids, tile_m, k, n)}"
              f"  [{card}]", flush=True)
        del a, b
        torch.cuda.empty_cache()


def _wgrad_walk(gids, tile_m: int, k: int, n: int, e: int = 8) -> str:
    """Expert rows and the balance of B12's persistent walk as csrc/gmm.cu
    deals it (tiles of 128 K rows x 256 columns, expert outermost; block b
    of one per SM takes tiles b, b + SMs, ...; a tile's work is its
    expert's 64-row stages): the most stages a block walks over the mean."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = np.bincount(gids.cpu().numpy(), minlength=e) * tile_m
    per_expert = -(-k // 128) * -(-n // 256)
    stages = np.repeat(-(-rows // 64), per_expert)
    per_block = np.bincount(np.arange(len(stages)) % sms, weights=stages, minlength=sms)
    return (f"expert rows {rows.tolist()}, walk max/mean stages per block "
            f"{per_block.max() / per_block.mean():.4f}")


SESSION_ROUNDS = 10


def session(card: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = smoke.slice_config()
    params = vita.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    kw = dict(max_len=2048, n_slots=4, prefill_chunk=256, page_size=64,
              decode_moe_mode="gather", device=dev)
    reuse, cold = Engine(params, cfg, **kw), Engine(params, cfg, **kw)
    for e in (reuse, cold):
        e.warmup(prompt_lens=(512, 1024), media=True, max_new_tokens=2)
    turn1, turn2, _ = smoke.session_turns(cfg, smoke.SEED + 9)

    def pair(key):
        first = turn1([])
        first.session_key = key
        smoke.serve(reuse, [first])
        again = turn2([first.tokens])
        again.session_key = key
        return again, turn2([first.tokens])

    ttft = {"reused": [], "cold": []}
    for i in range(SESSION_ROUNDS):
        again, ref = pair(f"round{i}")
        order = [(reuse, again, "reused"), (cold, ref, "cold")]
        for engine, req, name in (order if i % 2 == 0 else order[::-1]):
            smoke.serve(engine, [req])
            ttft[name].append(req.ttft_s * 1e3)
        if again.tokens != ref.tokens or reuse.stats()["reused_prefix_rows"] != 256 * (i + 1):
            raise AssertionError(f"round {i}: streams or reuse differ")
        print(f"  round {i} ({'reused' if i % 2 == 0 else 'cold'} first): TTFT reused "
              f"{ttft['reused'][-1]:.2f} ms, cold {ttft['cold'][-1]:.2f} ms  [{card}]", flush=True)
    diff = np.subtract(ttft["cold"], ttft["reused"])
    for name, v in ttft.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        print(f"  turn 2 TTFT {name}: median {med:.2f} ms, quartiles {q1:.2f}-{q3:.2f}  "
              f"[{card}]", flush=True)
    print(f"  cold - reused per round: median {np.median(diff):.2f} ms, least "
          f"{diff.min():.2f}, largest {diff.max():.2f}; reused faster in "
          f"{int((diff > 0).sum())} of {len(diff)} rounds  [{card}]", flush=True)
    again, ref = pair("profiled")
    for engine, req, name in ((reuse, again, "reused turn 2"), (cold, ref, "cold turn 2")):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            smoke.serve(engine, [req])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        _summarize(prof, wall, f"{name} (prefill + 16 tokens)", card)


WHALE_ROUNDS = 5


def whale(card: str) -> None:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.models import whale as whale_mod

    dev = torch.device("cuda")
    base = smoke.slice_config().audio
    params = whale_mod.init_params(base, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    cfgs = {b: dataclasses.replace(base, attn_backend=b) for b in ("flash", "xla")}
    rng = np.random.default_rng(smoke.SEED)
    for seconds, frames in smoke.WHALE_CLIPS:
        speech = torch.from_numpy(rng.standard_normal((1, frames, base.input_dim),
                                                      np.float32)).to(dev)
        lens = torch.tensor([frames], device=dev)

        def fwd(b):
            with torch.no_grad():
                return whale_mod.forward(params, cfgs[b], speech, lens)

        times = {b: [] for b in cfgs}
        for b in cfgs:
            fwd(b)
        for r in range(WHALE_ROUNDS):
            for b in (("flash", "xla") if r % 2 == 0 else ("xla", "flash")):
                times[b].append(smoke.cuda_ms(lambda b=b: fwd(b), n=1, warmup=0))
        print(f"  Whale {seconds} s ({frames} frames): " + "; ".join(
            f"{b} median {np.median(t):.3f} ms (rounds {', '.join(f'{x:.3f}' for x in t)})"
            for b, t in times.items()) + f"  [{card}]", flush=True)
        for b in cfgs:
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fwd(b)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            _summarize(prof, wall, f"Whale {seconds} s, {b}", card, top=8)
        del speech
        torch.cuda.empty_cache()


# (expert, model) axes of the meshes `mesh` holds against the unsharded Engine
MESH_PROBE_AXES = ((2, 2), (1, 4), (4, 1))
MESH_PROBE_KW = dict(n_slots=4, page_size=64, decode_moe_mode="gather")


@contextlib.contextmanager
def _recording_logits(engine, prefill, decode):
    """While open, ``engine``'s prefill samples append their logits row to
    ``prefill``, and each decode step stores the row of every active
    request as decode[(request_id, i)] for generated token i."""
    from vita_tpu_torch import sampling
    from vita_tpu_torch.serve import engine as engine_mod

    real_pre, real_chunk, real_sample = (engine_mod.sample_tokens, engine_mod.decode_chunk,
                                         sampling.sample_tokens)

    def pre_sample(logits, *a, **k):
        prefill.append(logits[0].float().cpu().numpy())
        return real_pre(logits, *a, **k)

    def chunk(llm_params, cache, tok, pos, *args, **kw):
        reqs = [r for r in engine.slot_req if r is not None]
        first = [int(p) + 1 - len(r.input_ids) for p, r in zip(pos.tolist(), reqs)]
        step = [0]

        def sample(logits, *a, **k):
            rows = logits.float().cpu().numpy()
            for row, r in enumerate(reqs):
                decode[(r.request_id, first[row] + step[0])] = rows[row]
            step[0] += 1
            return real_sample(logits, *a, **k)

        sampling.sample_tokens = sample
        try:
            return real_chunk(llm_params, cache, tok, pos, *args, **kw)
        finally:
            sampling.sample_tokens = real_sample

    engine_mod.sample_tokens, engine_mod.decode_chunk = pre_sample, chunk
    try:
        yield
    finally:
        engine_mod.sample_tokens, engine_mod.decode_chunk = real_pre, real_chunk


def _mesh_probe_run(engine, cfg):
    """chip_smoke's bf16 full-width traffic with logits and routes recorded,
    keyed by request index: (streams, prefill rows, decode rows, routes)."""
    warm, solo, wave = smoke.mesh_full_requests(cfg, smoke.MESH_FULL_RUNS[0][2])
    smoke.serve(engine, warm)
    prefill, decode, routes = [], {}, {}
    with _recording_logits(engine, prefill, decode), smoke._recording_routes(engine, routes):
        reqs = smoke.serve(engine, solo) + smoke.serve(engine, wave)
    ids = [r.request_id for r in reqs]
    index = lambda d: {(ids.index(k[0]),) + k[1:]: v for k, v in d.items() if k[0] in ids}
    return [r.tokens for r in reqs], prefill, index(decode), index(routes)


def mesh_probe_rank(rank, world, ckpt_dir):
    """Each MESH_PROBE_AXES mesh over the slice's checkpoint in
    ``ckpt_dir`` (each rank reads its shards) on cuda:0; rank 0 returns
    its runs."""
    import torch

    from vita_tpu_torch import kernels
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.parallel.mesh import make_mesh
    from vita_tpu_torch.serve.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.lib()
    cfg = smoke.slice_config()
    dev = torch.device("cuda", 0)
    runs = []
    for axes in MESH_PROBE_AXES:
        mesh = make_mesh((1, 1) + axes)
        _, shards = load_vita_checkpoint(ckpt_dir, dev, mesh=mesh)
        engine = Engine(shards, cfg, max_len=2048, device=dev, mesh=mesh, sharded=True,
                        **MESH_PROBE_KW)
        runs.append(_mesh_probe_run(engine, cfg))
        del engine, shards
        gc.collect()
        torch.cuda.empty_cache()
    return runs if rank == 0 else None


def mesh(card: str) -> None:
    import os

    import torch

    from vita_tpu_torch.checkpoint import export_hf_vita_checkpoint
    from vita_tpu_torch.parallel.launch import run_ranks
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = smoke.slice_config()
    params = smoke.slice_params(cfg, dev)
    engine = Engine(params, cfg, max_len=2048, device=dev, **MESH_PROBE_KW)
    ref = _mesh_probe_run(engine, cfg)
    del engine
    shutil.rmtree(smoke.MESH_DIR, ignore_errors=True)
    ckpt_dir = os.path.join(smoke.MESH_DIR, "ckpt")
    try:
        export_hf_vita_checkpoint(ckpt_dir, cfg, params, dtype=torch.bfloat16)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        runs = run_ranks(mesh_probe_rank, 4, ckpt_dir, timeout=900, store_dir=smoke.MESH_DIR)[0]
    finally:
        shutil.rmtree(smoke.MESH_DIR, ignore_errors=True)
    for axes, (tokens, prefill, decode, routes) in zip(MESH_PROBE_AXES, runs):
        print(f"  mesh expert {axes[0]} x model {axes[1]} against the unsharded Engine "
              f"(bf16, logits of std {np.std(ref[1][0]):.3f})  [{card}]", flush=True)
        for i, (a, b) in enumerate(zip(ref[1], prefill)):
            print(f"    prefill sample {i}: max |logit difference| {np.abs(a - b).max():.4f}",
                  flush=True)
        for i, (got, want) in enumerate(zip(tokens, ref[0])):
            j = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), len(want))
            diffs = [float(np.abs(decode[(i, t)] - ref[2][(i, t)]).max())
                     for t in range(1, j + 1) if (i, t) in decode and (i, t) in ref[2]]
            keys = sorted(k for k in ref[3] if k[:2] == (i, "prompt")) + [
                (i, t) for t in range(1, j + 1)]
            flip = next((f"{k[1:]} layer {layer}, unsharded router gap {g:.3e}"
                         for k in keys
                         for layer, ((x, g), (y, _)) in enumerate(zip(ref[3].get(k, []),
                                                                      routes.get(k, [])))
                         if x != y), "none")
            state = "identical" if j == len(want) else f"splits at token {j}"
            print(f"    request {i}: {state}; max |logit difference| per decode step up to "
                  f"it {[round(d, 4) for d in diffs]}; first route that differs: {flip}",
                  flush=True)


# (name, (file, line as committed, line as planted)): faults of rounding
# size or worse in the serving mesh's sums, each of which phase 11 must fail
MESH_FAULTS = (
    ("as committed", None),
    ("M1: wo partials rounded to bf16",
     ("vita_tpu_torch/models/mixtral.py",
      "part = torch.mm(o.reshape(-1, o.shape[-1]), wo, out_dtype=torch.float32)",
      "part = (o.reshape(-1, o.shape[-1]) @ wo).float()")),
    ("M2: the sum over 'model' of the output projection dropped",
     ("vita_tpu_torch/models/mixtral.py",
      "return all_reduce_sum(part, mesh, MODEL).to(o.dtype)", "return part.to(o.dtype)")),
    ("M3: the expert partials left in bf16",
     ("vita_tpu_torch/parallel/sharded_ops.py",
      "n_experts=e_local, out_dtype=torch.float32, pairs=pairs)",
      "n_experts=e_local, pairs=pairs)")),
)


def _fault_runs(card: str, faults, code: str, phase: str, prefixes) -> None:
    """Each of ``faults`` (name, edits of (file, text as committed, text as
    planted)) on a copy of the tree under build/faults/ (no edit: the tree
    as it is), where ``code`` runs ``phase`` in a fresh process: its exit
    code, the lines of its output that start with ``prefixes`` and the
    failures it listed."""
    import subprocess

    from vita_tpu_torch import kernels

    kernels.build()  # the copies take the built library along
    base = os.path.join(smoke.ROOT, "build", "faults")
    tree = os.path.join(base, "tree")
    try:
        for name, edits in faults:
            shutil.rmtree(tree, ignore_errors=True)
            shutil.copytree(smoke.ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "faults", "smoke_*", "archive", "chiprun_out"))
            for path, old, new in edits:
                with open(os.path.join(tree, path)) as f:
                    src = f.read()
                if src.count(old) != 1:
                    raise RuntimeError(f"{name}: {path} holds {src.count(old)} copies of {old!r}")
                with open(os.path.join(tree, path), "w") as f:
                    f.write(src.replace(old, new))
            t0 = time.time()
            run = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                                 text=True, timeout=900)
            print(f"  -- {name}: {phase} exit {run.returncode} in {time.time() - t0:.1f} s "
                  f"[{card}]", flush=True)
            for line in run.stdout.splitlines():
                if line.startswith(prefixes):
                    print("  " + line, flush=True)
            err = run.stderr.splitlines()
            start = next((i for i, l in enumerate(err) if f"{phase} failed" in l), None)
            if start is not None:
                print("\n".join("    " + l for l in err[start:]), flush=True)
            elif run.returncode:
                print("\n".join(err[-20:]), flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)


def mesh_faults(card: str) -> None:
    _fault_runs(card, [(name, () if edit is None else (edit,)) for name, edit in MESH_FAULTS],
                "import torch, chip_smoke as cs\n"
                "cs.mesh_phase(cs.card_line(), torch.device('cuda'))",
                "phase 11", ("  narrow", "  full width", "  layer 0"))


# (name, edits of (file, text as committed, text as planted)): faults of the
# ring and of the seq-parallel aux loss, each of which phase 12's (a) or
# (b) must fail
SEQ_FAULTS = (
    ("as committed", ()),
    ("S1: each rank's last ring step's dq dropped",
     (("vita_tpu_torch/parallel/ring_attention.py", "dq += bwd_dq(*args).float()",
       "dq += bwd_dq(*args).float() * (t < n - 1)"),)),
    ("S2: the last shift of dk/dv home dropped",
     (("vita_tpu_torch/parallel/ring_attention.py",
       "dk, dv = shift_down([dk, dv], ctx.mesh, SEQ)", "pass"),)),
    ("S3: aux's sums over 'seq' summed in the backward too",
     (("vita_tpu_torch/parallel/mesh.py",
       "    def forward(ctx, x, mesh, names):\n        return _reduce(x, mesh, names)\n\n"
       "    @staticmethod\n    def backward(ctx, g):\n        return g, None, None",
       "    def forward(ctx, x, mesh, names):\n        ctx.axis = (mesh, names)\n"
       "        return _reduce(x, mesh, names)\n\n"
       "    @staticmethod\n    def backward(ctx, g):\n"
       "        return _reduce(g.contiguous(), *ctx.axis), None, None"),)),
)


def seq_phase_ab(card: str) -> None:
    """chip_smoke.py phase 12's (a) and (b) alone: the unsharded training
    step here, then SEQ_RANKS ranks on cuda:0 over gloo; raises listing
    every check that failed."""
    import torch

    from vita_tpu_torch.parallel.launch import run_ranks

    ref, picks = smoke.seq_train_reference(card, torch.device("cuda"))
    plan = {"picks": picks, "ckpt_dir": None, "duplex": {}, "device": "cuda:0"}
    results = run_ranks(smoke.seq_duplex_rank, smoke.SEQ_RANKS, plan, backend="gloo",
                        timeout=600, store_dir=os.path.join(smoke.ROOT, "build"))
    failed = []
    smoke.seq_ring_report(card, [res["ring"] for res in results],
                          {n: float("nan") for n in smoke.SEQ_RING_LENGTHS}, failed)
    smoke.seq_train_report(card, [res["train"] for res in results], ref, failed)
    if failed:
        raise AssertionError("phase 12 failed:\n  " + "\n  ".join(failed))


def ring_faults(card: str) -> None:
    _fault_runs(card, SEQ_FAULTS,
                "import chip_smoke as cs, chip_probe as cp\ncp.seq_phase_ab(cs.card_line())",
                "phase 12", ("  (a)", "  (b)"))


RING_PROBE_MESHES = ((4, 1), (2, 2))  # (seq, model), as chip_smoke phase 12(a)
RING_PROBE_REPS = 3


def ring_probe_rank(rank, world, seq, model, reps):
    """One rank of ``ring``: phase 12(a)'s ring forward + backward at
    length SEQ_S; the last rank (the last seq block, which attends every
    block: the others skip the blocks in their future) runs each of
    ``reps`` repetitions under torch.profiler, the others unprofiled, and
    returns, per repetition, the wall ms, the host ms inside the ring's
    point-to-point shifts and each device entry's ms and count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch import kernels
    from vita_tpu_torch.parallel import ring_attention as ra
    from vita_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    kernels.lib()
    mesh = make_mesh((1, 1, 1, model, 1, seq))
    p2p = [0.0]
    real_shift = ra.shift_down

    def shift(*a, **k):
        t0 = time.perf_counter()
        out = real_shift(*a, **k)
        p2p[0] += (time.perf_counter() - t0) * 1e3
        return out

    ra.shift_down = shift
    q, k, v, do, lengths = smoke._ring_inputs(smoke.SEQ_S, dev)
    blocks = [smoke._seq_block(x, mesh) for x in (q, k, v)]
    dob = smoke._seq_block(do, mesh)

    def run():
        leaves = [x.clone().requires_grad_() for x in blocks]
        o, _ = ra.ring_flash_mha_with_lse(*leaves, lengths, causal=True, mesh=mesh)
        (o.float() * dob.float()).sum().backward()

    run()
    torch.cuda.synchronize(dev)
    out = []
    for _ in range(reps):
        p2p[0] = 0.0
        ctx = (torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if rank == world - 1 else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
        per = collections.defaultdict(lambda: [0.0, 0])
        if rank == world - 1:
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    per[_short(e.name)[:60]][0] += e.time_range.elapsed_us() / 1e3
                    per[_short(e.name)[:60]][1] += 1
        out.append(dict(wall=wall, p2p=p2p[0], device={k: tuple(v) for k, v in per.items()}))
    return out


def ring(card: str) -> None:
    """Ring attention (parallel.ring_attention) at chip_smoke phase 12(a)'s
    shapes (32 q / 8 kv heads of 128, bf16, B 1, S 8192, causal) on 4 ranks
    time-sharing cuda:0 over gloo, under seq 4 and seq 2 x model 2: on the
    last rank (it attends all n blocks, one B1, B10 and B11 a ring step),
    RING_PROBE_REPS profiled forward + backward passes, each with its wall
    ms, device ms (busy share = device / wall), the host ms inside the
    point-to-point shifts (staged through host memory over gloo) and each
    device entry's ms a launch; then the unsharded flash_mha's forward +
    backward alone on the card."""
    import torch

    from vita_tpu_torch.ops.flash_attention import flash_mha_with_lse
    from vita_tpu_torch.parallel.launch import run_ranks

    for seq, model in RING_PROBE_MESHES:
        world = seq * model
        reps = run_ranks(ring_probe_rank, world, seq, model, RING_PROBE_REPS,
                         backend="gloo", timeout=600,
                         store_dir=os.path.join(smoke.ROOT, "build"))[world - 1]
        for i, r in enumerate(reps):
            dev_ms = sum(ms for ms, _ in r["device"].values())
            print(f"  seq {seq} x model {model}, rank {world - 1}, pass {i + 1}: wall "
                  f"{r['wall']:.2f} ms, device {dev_ms:.2f} ms, busy {dev_ms / r['wall']:.3f}, "
                  f"host ms in the {2 * seq - 1} shifts {r['p2p']:.2f} ({smoke.MESH_NOTE}) "
                  f"[{card}]", flush=True)
            for name, (ms, n) in sorted(r["device"].items(), key=lambda kv: -kv[1][0])[:8]:
                print(f"      {ms:9.3f} ms {n:5d} launches, {ms / n:8.4f} ms a launch  {name}",
                      flush=True)
    dev = torch.device("cuda")
    q, k, v, do, lengths = smoke._ring_inputs(smoke.SEQ_S, dev)

    def unsharded():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o, _ = flash_mha_with_lse(*leaves, kv_len=lengths, causal=True)
        (o.float() * do.float()).sum().backward()

    for i in range(RING_PROBE_REPS):
        print(f"  unsharded flash_mha forward + backward, pass {i + 1}: "
              f"{smoke.cuda_ms(unsharded, n=10):.3f} ms [{card}]", flush=True)


# --------------------------------------------------------------------------
# pipeline parallelism (chip_smoke.py phase 13)
# --------------------------------------------------------------------------
PP_PROBE_KW = dict(n_slots=8, page_size=64, decode_moe_mode="gather")
PP_PROBE_NEW = 64


def _pp_probe_wave(cfg):
    rng = np.random.default_rng(smoke.SEED + 41)
    return [smoke.text_request(cfg, rng, n, PP_PROBE_NEW) for n in WAVE]


def _device_ms(prof) -> float:
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def pp_probe_rank(rank, world, ckpt_dir):
    """One rank of ``pp``: the full-width slice under pipe 4 (this rank's
    layer and pool), PP_PROBE_KW, a warm-up wave, then WAVE's eight text
    requests of PP_PROBE_NEW new tokens, the last rank under
    torch.profiler: wall and device ms, the ring's shifts' host ms, TTFT
    and tok/s."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch import kernels
    from vita_tpu_torch.checkpoint import load_vita_checkpoint
    from vita_tpu_torch.parallel.mesh import make_mesh
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda", 0)
    kernels.lib()
    mesh = make_mesh((1, 1, 1, 1, world))
    cfg = smoke.slice_config()
    _, shards = load_vita_checkpoint(ckpt_dir, dev, mesh=mesh)
    engine = Engine(shards, cfg, max_len=2048, device=dev, mesh=mesh, sharded=True,
                    **PP_PROBE_KW)
    smoke.serve(engine, _pp_probe_wave(cfg))  # warm-up: first-use costs
    shifts = []
    ctx = (torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if rank == world - 1 else contextlib.nullcontext())
    with ctx as prof, smoke._timing_ring(shifts):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        reqs = smoke.serve(engine, _pp_probe_wave(cfg))
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    return dict(wall=wall, device=_device_ms(prof) if rank == world - 1 else None,
                shift_ms=[t * 1e3 for t in shifts],
                ttft=[r.ttft_s * 1e3 for r in reqs], tok_s=[r.decode_tokens_per_s for r in reqs],
                tokens=sum(len(r.tokens) for r in reqs),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def pp(card: str) -> None:
    """The full-width 4-layer slice served with PP_PROBE_KW (bf16 experts,
    8 slots) under --mesh 1 1 4, 4 ranks time-sharing cuda:0 over gloo,
    against the unsharded Engine alone on the card: after a warm-up wave,
    WAVE's eight text requests of PP_PROBE_NEW new tokens; the unsharded
    run and the last rank (the one that finishes each token) under
    torch.profiler: wall ms, device ms, busy share, aggregate tok/s, TTFT,
    and the host ms of each ring substep's shift (median, p90, count)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.checkpoint import export_hf_vita_checkpoint
    from vita_tpu_torch.parallel.launch import run_ranks
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = smoke.slice_config()
    params = smoke.slice_params(cfg, dev)
    engine = Engine(params, cfg, max_len=2048, device=dev, **PP_PROBE_KW)
    smoke.serve(engine, _pp_probe_wave(cfg))
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = smoke.serve(engine, _pp_probe_wave(cfg))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = _device_ms(prof)
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"  unsharded, 8 text requests x {PP_PROBE_NEW} new tokens: wall {wall:.1f} ms, "
          f"device {dev_ms:.1f} ms, busy {dev_ms / wall:.3f}, {n_tok / wall * 1e3:.1f} tok/s "
          f"in all, TTFT {[round(r.ttft_s * 1e3, 1) for r in reqs]} ms [{card}]", flush=True)
    del engine
    shutil.rmtree(smoke.MESH_DIR, ignore_errors=True)
    os.makedirs(smoke.MESH_DIR)
    ckpt = os.path.join(smoke.MESH_DIR, "ckpt")
    try:
        export_hf_vita_checkpoint(ckpt, cfg, params, dtype=torch.bfloat16)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        res = run_ranks(pp_probe_rank, 4, ckpt, backend="gloo", timeout=600,
                        store_dir=smoke.MESH_DIR)
    finally:
        shutil.rmtree(smoke.MESH_DIR, ignore_errors=True)
    last = res[-1]
    for r, out in enumerate(res):
        shift = np.asarray(out["shift_ms"])
        busy = (f", device {out['device']:.1f} ms, busy {out['device'] / out['wall']:.3f}"
                if out["device"] is not None else "")
        print(f"  --mesh 1 1 4 rank {r} (stage {r}): wall {out['wall']:.1f} ms{busy}, "
              f"{out['tokens'] / out['wall'] * 1e3:.1f} tok/s in all, TTFT "
              f"{[round(t, 1) for t in out['ttft']]} ms, ring shift host ms a substep median "
              f"{np.median(shift):.3f} p90 {np.percentile(shift, 90):.3f} over {len(shift)} "
              f"substeps ({shift.sum():.1f} ms in all), peak {out['peak_gib']:.2f} GiB "
              f"({smoke.MESH_NOTE}) [{card}]", flush=True)
    assert all(o["tokens"] == last["tokens"] for o in res)


# (name, edits of (file, text as committed, text as planted)): faults of the
# pipeline, each of which phase 13's (a) or (c) must fail
PIPE_FAULTS = (
    ("as committed", ()),
    ("P1: the ring's wrap carries the last stage's hidden, not the new token's embedding",
     (("vita_tpu_torch/parallel/pp_serving.py", "out = emb[:, None].to(y.dtype)", "out = y"),
      ("vita_tpu_torch/parallel/pipeline.py", "out = emb.to(y.dtype)", "out = y"))),
    ("P2: bubble steps of the GPipe prefill compute on zeros and write KV rows",
     (("vita_tpu_torch/parallel/pipeline.py",
       "        if _valid(j, w_waves):\n"
       "            cw = _tree_map(lambda c: c[j], consts)\n"
       "            y = x[j] if s == 0 else held\n",
       "        if j >= 0:\n"
       "            j, jt = min(j, w_waves - 1), j\n"
       "            cw = _tree_map(lambda c: c[j], consts)\n"
       "            y = x[j] if s == 0 else (torch.zeros_like(x[0]) if held is None else held)\n"),
      ("vita_tpu_torch/parallel/pipeline.py",
       "        held = shift_up([x[0] if y is None else y], mesh, PIPE, send=_valid(j, w_waves),\n"
       "                        recv=_valid(j + 1, w_waves))",
       "        j = jt if j >= 0 else j\n"
       "        held = shift_up([x[0] if y is None else y], mesh, PIPE, send=_valid(j, w_waves),\n"
       "                        recv=_valid(j + 1, w_waves))"))),
    ("P3: the GPipe backward sends zeros upstream in place of dL/dx",
     (("vita_tpu_torch/parallel/pipeline.py",
       "got = shift_down([dx if dx is not None else template]",
       "got = shift_down([torch.zeros_like(dx) if dx is not None else template]"),)),
)


def pp_faults(card: str) -> None:
    _fault_runs(card, PIPE_FAULTS,
                "import torch, chip_smoke as cs\n"
                "cs.pipe_phase(cs.card_line(), torch.device('cuda'))",
                "phase 13", ("  (a)", "  (c)"))


# --------------------------------------------------------------------------
# sharded training over 'fsdp' (chip_smoke.py phase 14)
# --------------------------------------------------------------------------
FSDP_PROBE_MESH = (1, 4, 1, 1)


def fsdp_probe_rank(rank, world, plan):
    """One rank of ``fsdp``: phase 14(b)'s full-width step under
    FSDP_PROBE_MESH after a warm-up step; rank 0 under torch.profiler.
    Returns the wall ms, device ms (rank 0), the host ms inside the
    forward gathers and the backward reductions (``all_gather_cat``'s
    autograd Function, every leaf), their counts, and the peak."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch import kernels
    from vita_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda", 0)
    kernels.lib()
    mesh = pm.make_mesh(FSDP_PROBE_MESH)
    cfg = smoke.fsdp_full_config()
    batches = smoke.fsdp_batches(cfg, 2, smoke.FSDP_FULL_B, smoke.FSDP_FULL_S,
                                 smoke.FSDP_FULL_FRAMES, smoke.SEED + 62)
    spent = {"gather": [0.0, 0], "reduce": [0.0, 0]}
    real_fwd, real_bwd = pm._GatherCat.forward, pm._GatherCat.backward

    def timed(kind, fn):
        def run(*a):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize(dev)
            spent[kind][0] += (time.perf_counter() - t0) * 1e3
            spent[kind][1] += 1
            return out
        return staticmethod(run)

    pm._GatherCat.forward = timed("gather", real_fwd)
    pm._GatherCat.backward = timed("reduce", real_bwd)
    from vita_tpu_torch.train.trainer import RunConfig, Trainer

    params = smoke.slice_params(cfg, dev)
    run = RunConfig(output_dir=os.path.join(smoke.TRAIN_DIR, "fsdp_probe"),
                    batch_size=smoke.FSDP_FULL_B, resume=False)
    trainer = Trainer(cfg, smoke._fsdp_tc(True), run, params, mesh=mesh, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    p, s = trainer.params, trainer.opt_state
    p, s, _ = trainer.step_fn(p, s, batches[0])
    for v in spent.values():
        v[:] = [0.0, 0]
    ctx = (torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if rank == 0 else contextlib.nullcontext())
    with ctx as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        p, s, m = trainer.step_fn(p, s, batches[1])
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    return dict(wall=wall, device=_device_ms(prof) if rank == 0 else None,
                spent={k: tuple(v) for k, v in spent.items()}, loss=float(m["loss"]),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def fsdp(card: str) -> None:
    """Phase 14(b)'s full-width step (the 2-layer slice, 4 rows of 2048)
    under --mesh 1 4 1 1, 4 ranks time-sharing cuda:0 over gloo: each
    rank's wall ms, peak, and host ms inside the fsdp gathers (forward and
    remat recompute) and the backward's reductions, in all and a layer;
    rank 0's device ms and busy share (torch.profiler)."""
    from vita_tpu_torch.parallel.launch import run_ranks

    res = run_ranks(fsdp_probe_rank, 4, None, backend="gloo", timeout=900,
                    store_dir=os.path.join(smoke.ROOT, "build"))
    layers = smoke.fsdp_full_config().llm.n_layers
    for r, out in enumerate(res):
        (g_ms, g_n), (r_ms, r_n) = out["spent"]["gather"], out["spent"]["reduce"]
        busy = (f", device {out['device']:.1f} ms, busy {out['device'] / out['wall']:.3f}"
                if out["device"] is not None else "")
        print(f"  --mesh 1 4 1 1 rank {r}: step wall {out['wall']:.1f} ms{busy}; gathers "
              f"{g_n} in {g_ms:.1f} ms host ({g_ms / layers:.1f} a layer, the towers', "
              f"projectors', embedding's and head's included), reductions {r_n} in "
              f"{r_ms:.1f} ms ({r_ms / layers:.1f} a layer); peak {out['peak_gib']:.2f} GiB; "
              f"loss {out['loss']:.6f} ({smoke.FSDP_NOTE}) [{card}]", flush=True)


# --------------------------------------------------------------------------
# tensor- and expert-parallel training (chip_smoke.py phase 15)
# --------------------------------------------------------------------------
def tp_phase_b(card: str, small: bool = False) -> None:
    """chip_smoke.py phase 15's (b) alone: the unsharded Trainer's
    steps and the float32 gradients at the samples here, then the
    full-width slice under TP_FULL_MESHES on 4 gloo ranks on cuda:0; for
    each trainable leaf, the sampled gradient's largest distance from the
    unsharded bf16 step's and of both from the float32 gradient (each over
    the leaf's largest); raises listing every check that failed. With
    ``small``, the tiny config on the CPU (``fsdp_full_config(small)``)."""
    import numpy as np
    import torch

    from vita_tpu_torch.parallel.launch import run_ranks

    dev = torch.device("cpu" if small else "cuda")
    cfg = smoke.fsdp_full_config(small)
    full_s = 64 if small else smoke.FSDP_FULL_S
    batch = smoke.fsdp_full_batch(cfg, full_s)
    full_ref, picks = smoke.fsdp_full_reference(cfg, batch, dev)
    f32 = smoke.full_f32_gradients(cfg, batch, dev, picks)
    plan = {"device": "cpu" if small else "cuda:0", "small": small, "full_s": full_s,
            "picks": picks,
            "shapes": full_ref["shapes"], "narrow_meshes": (),
            "full_meshes": smoke.TP_FULL_MESHES, "cli": []}
    results = run_ranks(smoke.fsdp_rank, smoke.FSDP_RANKS, plan, backend="gloo", timeout=900,
                        store_dir=os.path.join(smoke.ROOT, "build"))
    failed = []
    for shape in smoke.TP_FULL_MESHES:
        for leaf, g_ref in full_ref["grads"].items():
            g = smoke._gather_samples(results, shape, leaf, "grads", "(b)", failed)
            top = max(np.abs(f32[leaf]).max(), 1e-30)
            d_mesh, d_ref = np.abs(g - f32[leaf]).max() / top, np.abs(g_ref - f32[leaf]).max() / top
            print(f"  TP {' '.join(map(str, shape))} {leaf}: |mesh - unsharded| "
                  f"{np.abs(g - g_ref).max() / max(np.abs(g_ref).max(), 1e-30):.3e}; from float32 "
                  f"mesh {d_mesh:.3e}, unsharded {d_ref:.3e} (ratio {d_mesh / max(d_ref, 1e-30):.3f})",
                  flush=True)
    smoke._full_report(card, results, smoke.TP_FULL_MESHES, full_ref, full_s, dev, failed,
                       f32=f32)
    if failed:
        raise AssertionError("phase 15 failed:\n  " + "\n  ".join(failed))


# (name, edits of (file, text as committed, text as planted)): a missing
# collective of tensor-parallel training, and the experts' partials as the
# serving mesh's M3 rounds them
TP_FAULTS = (
    ("as committed", ()),
    ("T1: the 'f' over 'model' on the attention's input dropped",
     (("vita_tpu_torch/models/mixtral.py",
       "q, k, v = _qkv(lp, cfg, all_reduce_grad(x, mesh, MODEL), positions)",
       "q, k, v = _qkv(lp, cfg, x, positions)"),)),
    ("T2: the experts' ffn-column partials rounded to bf16 before their sum",
     (("vita_tpu_torch/parallel/sharded_ops.py",
       "out_dtype=torch.float32 if split_f else None", "out_dtype=None"),)),
)


def tp_faults(card: str) -> None:
    _fault_runs(card, TP_FAULTS,
                "import chip_smoke as cs, chip_probe as cp\ncp.tp_phase_b(cs.card_line())",
                "phase 15", ("  TP", "  (b)", "    routing"))


# --------------------------------------------------------------------------
# serving over data/fsdp (chip_smoke.py phase 14(a) and (d))
# --------------------------------------------------------------------------
DP_PROBE_MESH = (1, 4, 1, 1)
DP_PROBE_RUNS = (
    ("bf16 experts", dict(decode_moe_mode="gather", prefill_moe_mode="gmm")),
    ("int8 experts, int8 KV", dict(decode_moe_mode="gather_q", kv_int8=True,
                                   prefill_moe_mode="gmm")),
    ("int4 experts, int8 KV", dict(decode_moe_mode="gather_q4", kv_int8=True,
                                   prefill_moe_mode="gmm")),
)


def dp_serve_probe_rank(rank, world, small):
    """One rank of ``dp-serve``: each DP_PROBE_RUNS Engine over
    DP_PROBE_MESH built from the whole weights on the host, serving
    phase 14(d)'s requests (rank 0 under torch.profiler): wall and device
    ms, the gathers' host ms by kind (smoke._timing_gathers), build s,
    peak, TTFT and tok/s."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch import kernels
    from vita_tpu_torch.parallel.mesh import make_mesh
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cpu" if small else "cuda:0")
    if not small:
        kernels.lib()
    mesh = make_mesh(DP_PROBE_MESH)
    cfg = smoke.fsdp_full_config(small)
    host = smoke._to(smoke.slice_params(cfg, dev), "cpu")
    out = {}
    for label, kw in DP_PROBE_RUNS:
        if not small:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        spent, build = {}, {}
        with smoke._timing_gathers(build):
            t0 = time.perf_counter()
            engine = Engine(host, cfg, mesh=mesh, device=dev, **smoke.DP_SERVE_KW, **kw)
            built = time.perf_counter() - t0
        timed = rank == 0 and not small
        ctx = (torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if timed else contextlib.nullcontext())
        with smoke._timing_gathers(spent):
            with ctx as prof:
                smoke._sync(dev)
                t0 = time.perf_counter()
                reqs = smoke.serve(engine, smoke.dp_serve_requests(cfg))
                smoke._sync(dev)
                wall = (time.perf_counter() - t0) * 1e3
        out[label] = dict(wall=wall, device=_device_ms(prof) if timed else None, spent=spent,
                          build=build.get("other", (0.0, 0, 0)), built_s=built,
                          ttft=[r.ttft_s * 1e3 for r in reqs],
                          tok_s=[r.decode_tokens_per_s for r in reqs],
                          peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if not small
                          else 0.0)
        del engine
        gc.collect()
    return out


def dp_serve(card: str, small: bool = False) -> None:
    """Phase 14(d)'s weights and traffic served over --mesh 1 4 1 1 by
    each DP_PROBE_RUNS Engine (4 gloo ranks on cuda:0; ``small``: the tiny
    config on the CPU): per rank, the host ms of the fsdp gathers a
    prefill chunk and a decode step, those of the quantized copy at the
    build, the peak, TTFT and tok/s; rank 0's device ms and busy share."""
    from vita_tpu_torch.parallel.launch import run_ranks

    res = run_ranks(dp_serve_probe_rank, 4, small, backend="gloo", timeout=900,
                    store_dir=os.path.join(smoke.ROOT, "build"))
    for label, _ in DP_PROBE_RUNS:
        for r, out in enumerate(res):
            run = out[label]
            parts = []
            for kind, name, what in (("prefill", "prefill", "a prefill chunk"),
                                     ("decode", "decode", "a decode step"),
                                     ("other", "the prompts' embedding", "")):
                ms, n_g, n_f = run["spent"].get(kind, (0.0, 0, 0))
                each = f" ({ms / n_f:.1f} ms {what})" if n_f else ""
                parts.append(f"{name} {ms:.1f} ms in {n_g} gathers{each}")
            ms, n_g, _ = run["build"]
            parts.append(f"the Engine's build {ms:.1f} ms in {n_g} gathers")
            busy = (f", device {run['device']:.1f} ms, busy {run['device'] / run['wall']:.3f}"
                    if run["device"] is not None else "")
            print(f"  dp-serve --mesh 1 4 1 1 {label} rank {r}: built in {run['built_s']:.1f} s, "
                  f"served in {run['wall']:.1f} ms{busy}; gathers: {'; '.join(parts)}; peak "
                  f"{run['peak_gib']:.2f} GiB; TTFT {[round(t, 1) for t in run['ttft']]} ms, "
                  f"decode {[round(t, 3) for t in run['tok_s']]} tok/s ({smoke.FSDP_NOTE}) "
                  f"[{card}]", flush=True)


def dp_phase_ad(card: str, small: bool = False) -> None:
    """chip_smoke.py phase 14's capacity case of (a) and (d)'s int4 run
    with the int8 copy alone: the unsharded runs here, then 4 gloo ranks
    on cuda:0 (``small``: the tiny config on the CPU); raises listing
    every check that failed."""
    import torch

    from vita_tpu_torch.parallel.launch import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu" if small else "cuda")
    narrow = tuple(smoke.NARROW_WHOLE_BATCH)[:1]
    runs = [run for run in smoke.DP_SERVE_RUNS if run[2]["decode_moe_mode"] == "gather_q4"]
    narrow_ref = smoke._narrow_refs(narrow, dev)
    serve_ref = smoke.dp_serve_reference(card, smoke.dp_serve_config(small), dev, runs)
    plan = {"device": "cpu" if small else "cuda:0", "small": small, "narrow_meshes": narrow,
            "full_meshes": (), "serve": [run[0] for run in runs], "cli": []}
    results = run_ranks(smoke.fsdp_rank, smoke.FSDP_RANKS, plan, backend="gloo", timeout=900,
                        store_dir=os.path.join(smoke.ROOT, "build"))
    failed = []
    smoke._narrow_report(results, narrow, narrow_ref, failed)
    smoke.dp_serve_report(card, results, serve_ref, dev, failed, runs)
    if failed:
        raise AssertionError("phase 14 failed:\n  " + "\n  ".join(failed))


# (name, edits of (file, text as committed, text as planted)): the
# quantized decode copy made from each rank's own block, and the capacity
# mode's drops and chunks taken over each rank's own tokens
DP_FAULTS = (
    ("as committed", ()),
    ("D1: decode_params quantizes each rank's own block of the experts",
     (("vita_tpu_torch/generate.py",
       "whole = {k: fsdp.gather(moe[k][i], cut[k], mesh)[None] for k in experts}",
       "whole = {k: torch.cat([moe[k][i]] * axis(mesh, FSDP).size,\n"
       "                               dim=cut[k].index(FSDP))[None] for k in experts}"),)),
    ("D2: capacity + moe_chunk over each rank's own tokens (_moe_over_batch skipped)",
     (("vita_tpu_torch/models/mixtral.py",
       "        if whole_batch:\n            moe_out, aux = _moe_over_batch(",
       "        if False:\n            moe_out, aux = _moe_over_batch("),)),
)


def dp_faults(card: str) -> None:
    _fault_runs(card, DP_FAULTS,
                "import chip_smoke as cs, chip_probe as cp\ncp.dp_phase_ad(cs.card_line())",
                "phase 14", ("  (a)", "  (d)"))


def main() -> int:
    import torch

    modes = {"profile": profile, "syncs": syncs, "bounds": bounds, "warps": warps, "gmm": gmm,
             "train": train, "flash": flash,
             "gmm-kernels": gmm_kernels, "gmm-tiles": gmm_tiles, "flash-fwd": flash_fwd,
             "flash-fwd-tiles": flash_fwd_tiles, "gmm-small": gmm_small,
             "gmm-small-order": gmm_small_order, "expert": expert,
             "expert-ring": expert_ring, "expert-q4": expert_q4,
             "expert-q4-ring": expert_q4_ring, "expert-q": expert_q, "paged": paged,
             "paged-ring": paged_ring, "session": session, "whale": whale,
             "mesh": mesh, "mesh-faults": mesh_faults, "ring": ring,
             "ring-faults": ring_faults, "pp": pp, "pp-faults": pp_faults, "fsdp": fsdp,
             "tp-faults": tp_faults, "dp-serve": dp_serve, "dp-faults": dp_faults}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "bounds":
        bounds()
        return 0
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from vita_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    kernels.lib()
    modes[sys.argv[1]](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
