#!/usr/bin/env python3
"""Measurements behind PERF.md that chip_smoke.py does not take, on one
NVIDIA GPU.

    python3 chip_probe.py profile   # where served decode's time goes
    python3 chip_probe.py warps     # warps per block of csrc/expert_ffn.cu

profile: chip_smoke.py's full-width 4-layer slice served by two engines on
8 slots (bf16 experts over bf16 KV pages; int4 experts over int8 KV
pages) under torch.profiler: one text request alone, then eight text
requests at once, 64 new tokens each, each after a warm-up with the same
traffic. Prints per run the wall time (profiler overhead included), the
device time (the sum of the kernels' and copies' durations), the busy
share (device over wall), the largest device entries and the host's
kernel launches.

warps: copies of vita_tpu_torch/csrc under build/warps/, each with another
choice of warps per block in expert_ffn.cu, built together and held
against the plain versions, then timed on the same inputs (CUDA events,
median of 25 after 3 warm-ups, two passes in opposite orders): the gather
schedule at T 1 and the masked one at T 4 (int4: 8), in bf16, int8 and
int4, at the serving width (D 4096, F 14336, 8 experts).

Each prints the card's name and power limit first.
"""

from __future__ import annotations

import collections
import ctypes
import gc
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from vita_tpu_torch.models import vita
    from vita_tpu_torch.serve.engine import Engine

    dev = torch.device("cuda")
    cfg = smoke.slice_config()
    params = vita.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    for label, options in ENGINES:
        engine = Engine(params, cfg, max_len=2048, device=dev, **options)
        for run, lengths in (("solo", WAVE[:1]), ("wave of 8 text", WAVE)):
            def traffic():
                rng = np.random.default_rng(smoke.SEED)
                return [smoke.text_request(cfg, rng, n, NEW_TOKENS) for n in lengths]

            smoke.serve(engine, traffic())
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                smoke.serve(engine, traffic())
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = prof.events()
            on_dev = collections.defaultdict(lambda: [0.0, 0])
            launches = [0, 0.0]
            for e in events:
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
            print(f"  {label}, {run}: wall {wall:.1f} ms, device {dev_ms:.1f} ms, busy "
                  f"{dev_ms / wall:.3f}, host launches {launches[0]} ({launches[1]:.2f} ms)"
                  f"  [{card}]", flush=True)
            for name, (ms, n) in sorted(on_dev.items(), key=lambda kv: -kv[1][0])[:6]:
                print(f"      {ms:9.2f} ms {n:6d} calls  {_short(name)}", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()


def _short(name: str) -> str:
    """A kernel's name without its parameter list and namespaces."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    return name.replace("void ", "").replace("vita::", "")[:110]


def _build_choices(root):
    """One library per WARP_CHOICES entry under ``root``: the other
    sources compiled once, expert_ffn.cu once per choice, all at once."""
    from vita_tpu_torch import kernels

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    nvcc = kernels._nvcc()
    text = (kernels.CSRC / "expert_ffn.cu").read_text()
    others = [s for s in sorted(kernels.CSRC.glob("*.cu")) if s.name != "expert_ffn.cu"]
    cmds = [[nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(root / f"{s.stem}.o"), str(s)]
            for s in others]
    dirs = []
    for i, (up, down) in enumerate(WARP_CHOICES.values()):
        d = root / f"choice{i}"
        d.mkdir()
        for h in kernels.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        src = text
        for fn, expr in (("up_warps", up), ("down_warps", down)):
            src, n = re.subn(rf"(constexpr int {fn}\(\) {{ return )[^;]*(; }})",
                             rf"\g<1>{expr}\g<2>", src)
            if n != 1:
                raise RuntimeError(f"expert_ffn.cu has no single {fn}() to replace")
        (d / "expert_ffn.cu").write_text(src)
        cmds.append([nvcc, *kernels.NVCC_FLAGS, "-c", "-o", str(d / "expert_ffn.o"),
                     str(d / "expert_ffn.cu")])
        dirs.append(d)
    kernels._run_all(cmds)
    kernels._run_all([[nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                       str(d / "expert_ffn.o"), *(str(root / f"{s.stem}.o") for s in others)]
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
    libs = _build_choices(kernels.BUILD_DIR.parent / "warps")
    print(f"  built {len(libs)} choices in {time.time() - t0:.1f} s", flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(smoke.SEED)
    d, f = 4096, 14336
    wg, wu, wd = smoke._expert_weights(rng, 8, d, f, bf16, dev)
    stack = {"router": wg.new_zeros(d, 8), "w_gate": wg, "w_up": wu, "w_down": wd}
    formats = (("bf16", None, 4), ("int8", md.quantize_expert_weights(stack), 4),
               ("int4", md.quantize_expert_weights_int4(stack), 8))
    cases = []  # (label, kernel, plain)
    for fmt, qp, t_masked in formats:
        x1 = torch.from_numpy(rng.standard_normal((1, d), np.float32)).to(dev, bf16)
        _, i1 = smoke._routing(rng, 1, 2, 8, 0, bf16, dev)
        xm = torch.from_numpy(rng.standard_normal((t_masked, d), np.float32)).to(dev, bf16)
        w, im = smoke._routing(rng, t_masked, 2, 8, 0, bf16, dev)
        act, m = md._active_expert_plan(w, im, 8)
        if qp is None:
            cases += [
                (f"{fmt} gather T=1", lambda x=x1, i=i1: md.gather_expert_ffn_cuda(x, i, wg, wu, wd),
                 lambda x=x1, i=i1: md.gather_expert_ffn_plain(x, i, wg, wu, wd)),
                (f"{fmt} masked T={t_masked}",
                 lambda x=xm, a=act, m=m: md.masked_expert_ffn_cuda(x, a, m, wg, wu, wd),
                 lambda x=xm, a=act, m=m: md.masked_expert_ffn_plain(x, a, m, wg, wu, wd))]
        else:
            b = 8 if fmt == "int8" else 4
            cases += [
                (f"{fmt} gather T=1",
                 lambda x=x1, i=i1, q=qp, b=b: md.gather_expert_ffn_q_cuda(x, i, q, b),
                 lambda x=x1, i=i1, q=qp, b=b: md.gather_expert_ffn_q_plain(x, i, q, b)),
                (f"{fmt} masked T={t_masked}",
                 lambda x=xm, a=act, m=m, q=qp, b=b: md.masked_expert_ffn_q_cuda(x, a, m, q, b),
                 lambda x=xm, a=act, m=m, q=qp, b=b: md.masked_expert_ffn_q_plain(x, a, m, q, b))]
    names = list(WARP_CHOICES)
    ms = {(c, n): [] for c, _, _ in cases for n in names}
    for label, run, plain in cases:
        want = plain()
        for n, lib in zip(names, libs):
            kernels._lib = lib
            smoke.compare(f"{label} with {n}", run(), want, 2e-2, 2e-2)
    for order in (range(len(names)), reversed(range(len(names)))):
        for k in order:
            kernels._lib = libs[k]
            for label, run, _ in cases:
                ms[(label, names[k])].append(smoke.cuda_ms(run))
    kernels._lib = None
    print(f"  kernel ms per choice (up/down warps), passes in opposite orders  [{card}]")
    for label, _, _ in cases:
        print(f"    {label}", flush=True)
        for n in names:
            a, b = ms[(label, n)]
            print(f"      {n:36s} {a:.4f}  {b:.4f}", flush=True)


def main() -> int:
    import torch

    if len(sys.argv) != 2 or sys.argv[1] not in ("profile", "warps"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from vita_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    print(card, flush=True)
    kernels.lib()
    {"profile": profile, "warps": warps}[sys.argv[1]](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
