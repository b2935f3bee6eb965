#!/usr/bin/env python3
"""Where the time of the ``rwkv6_scan`` CUDA kernel goes, on one NVIDIA card.

    python3 tools/rwkv_scan_ablation.py

No profiler reaches inside a kernel on the measuring machine, so this
builds ``src/repro_torch/kernels/csrc/rwkv6_scan.cu`` four times with
``nvcc`` (the flags of ``repro_torch.kernels._build``, into
``build/rwkv_scan_ablation/``): as it is, and with one part cut out each —
the loads (each ring stage is filled once, the rest of the run reuses it),
the arithmetic (the chunks' tokens are skipped: loads and barriers only),
and the column sums of y (each lane stores its own partial dot).  Each is
timed with CUDA events at RWKV6-3B's prefill shape (B 4, T 1024, H 40, D 64,
float32, the model's decay, with the final state), as the path calls it.
Only the kernel as it is gives the right numbers; it is checked against
the plain version to 1e-4.  A cut that no longer applies to the source
(the kernel was edited) stops the script.  The last line is a JSON object
with each variant's ms.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_reference  # noqa: E402

SHAPE = (4, 1024, 40, 64)
OUT = os.path.join(ROOT, "build", "rwkv_scan_ablation")
CUTS = {
    "kernel": [],
    "no_loads": [
        ("    mbar_wait(smem_u32(&full[s]), (c / kStages) & 1);",
         "    if (c < kStages) mbar_wait(smem_u32(&full[s]), (c / kStages) & 1);"),
        ("    if (tid == 0 && c + kStages < n_chunks) issue(s, c + kStages);", ""),
    ],
    "no_compute": [
        ("    if (n == kChunk) {", "    if (n < 0) {"),
        ("      for (int tb = 0; tb < n; tb += TB) batch(tb, n);",
         "      for (int tb = 0; tb < (n >> 30); tb += TB) batch(tb, n);"),
    ],
    "no_column_sums": [("      column_sums<TB * C, G>(p, lane);\n", "")],
}


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build() -> dict:
    src = (_build.CSRC / "rwkv6_scan.cu").read_text()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"rwkv_scan_ablation: the cut {name!r} no longer applies to "
                                 f"rwkv6_scan.cu (it looks for {old.strip()!r})")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"rwkv6_scan_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = path[:-3] + ".so"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"rwkv_scan_ablation: {name} did not build:\n{out}")
        fn = ctypes.CDLL(lib).rwkv6_scan_fwd
        fn.argtypes, fn.restype = _build.SIGNATURES["rwkv6_scan"][1:]
        libs[name] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("rwkv_scan_ablation: no CUDA device", file=sys.stderr)
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, d = SHAPE
    r, k, v = (torch.randn(SHAPE, generator=gen, device="cuda") * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.3 * torch.randn(SHAPE, generator=gen, device="cuda")))
    u = torch.randn((h, d), generator=gen, device="cuda") * 0.3
    y = torch.empty(SHAPE, device="cuda")
    S = torch.empty((b, h, d, d), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for name, fn in libs.items():
        def call(fn=fn):
            err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                     y.data_ptr(), S.data_ptr(), b, t, h, d, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        if name == "kernel":
            want_y, want_S = rwkv6_reference(*(x.transpose(1, 2) for x in (r, k, v, w)), u,
                                             return_state=True)
            if not (torch.allclose(y, want_y.transpose(1, 2), atol=1e-4, rtol=1e-4)
                    and torch.allclose(S, want_S, atol=1e-4, rtol=1e-4)):
                raise AssertionError("rwkv_scan_ablation: the kernel disagrees with its plain "
                                     "version")
            del want_y, want_S
        results[name] = cuda_ms(call)
        print(f"[ablation] rwkv6_scan {name}: {results[name]:.4f} ms", flush=True)
    print(gpu, flush=True)
    print(json.dumps({"shape": SHAPE, "ms": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
