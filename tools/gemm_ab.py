#!/usr/bin/env python3
"""Time variants of the port's hand-written GEMM side by side on one card.

    python3 tools/gemm_ab.py NAME=PATH[:FLAGS] [NAME=PATH[:FLAGS] ...]

Each PATH is a copy of ``marlin_tpu_torch/csrc/gemm.cu`` (with its C
interface: ``marlin_gemm_prep``, ``marlin_gemm``), FLAGS extra ``nvcc``
flags (space-separated, quoted). Every variant is built alone, with the
package's ``nvcc`` flags, into its own library under
``build/gemm_ab/``; its registers and spills are printed; it is held
against ``pallas_matmul_plain`` (f32 1e-4, bf16 2^-7 of max |plain|) and a
256 x 65536 x 256 f32 product against f64 (1e-4 of max |ref|); then the
variants that pass are timed by CUDA events at N^3 (env ``N``, default
20000) in f32 and bf16 for each tile of env ``TILES`` (default
``128x128x32``), in turns: each variant, then each again in reverse order.
``torch.matmul``'s times close the run. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL, BF16_TOL, F64_TOL = 1e-4, 2.0 ** -7, 1e-4


def build(name, path, flags, _build):
    out_dir = os.path.join(ROOT, "build", "gemm_ab")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib_{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
           str(_build.CSRC), *flags, path, "-o", out]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def bind(path):
    lib = ctypes.CDLL(path)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.marlin_gemm_prep.argtypes = [i, p, p, p, p, ll, ll, ll, ll, p]
    lib.marlin_gemm_prep.restype = i
    lib.marlin_gemm.argtypes = [i, i, i, i, p, p, p, ll, ll, ll, ll, p, p]
    lib.marlin_gemm.restype = i
    lib.marlin_error_string.argtypes = [i]
    lib.marlin_error_string.restype = ctypes.c_char_p
    return lib


def checks(torch, pk, gen, tiles) -> bool:
    ok = True
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        for tile in tiles:
            for m, k, n in ((257, 300, 199), (1, 129, 3), (1000, 1000, 1000)):
                a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
                b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
                want = pk.pallas_matmul_plain(a, b, *tile).float()
                err = float((pk.pallas_matmul(a, b, *tile).float() - want)
                            .abs().max())
                if not err <= tol * float(want.abs().max()):
                    print(f"  FAIL {dt} {tile} {m}x{k}x{n}: {err}")
                    ok = False
    a = torch.randn((256, 65536), generator=gen, device="cuda")
    b = torch.randn((65536, 256), generator=gen, device="cuda")
    ref = a.double() @ b.double()
    for tile in tiles:
        rel = float((pk.pallas_matmul(a, b, *tile).double() - ref).abs().max()
                    / ref.abs().max())
        print(f"  long k {tile}: {rel:.3e} of max |ref|")
        ok = ok and rel <= F64_TOL
    return ok


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_ab: torch.cuda is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from marlin_tpu_torch.ops import _build
    from marlin_tpu_torch.ops import pallas_kernels as pk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    tiles = [tuple(map(int, t.split("x")))
             for t in os.environ.get("TILES", "128x128x32").split(",")]
    jobs = []
    for arg in sys.argv[1:]:
        name, rest = arg.split("=", 1)
        path, _, flags = rest.partition(":")
        jobs.append((name, *build(name, path, flags.split(), _build)))
    libs = {}
    for name, out, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        regs = re.findall(r"gemm_kernelI(\w+?)EEv\S*' for 'sm_90a'\n.*?"
                          r"(\d+) bytes spill stores.*?Used (\d+) registers",
                          log, re.S)
        print(f"{name}: " + ", ".join(f"{t} {r} registers, {s} B spilled"
                                      for t, s, r in regs))
        libs[name] = bind(out)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    good = []
    for name, lib in libs.items():
        _build.load_library = lambda lib=lib: lib
        if checks(torch, pk, gen, tiles):
            good.append(name)
        print(f"{name}: checks {'pass' if name in good else 'FAIL'}")
    n = int(os.environ.get("N", "20000"))
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn((n, n), generator=gen, device="cuda")
    b = torch.randn((n, n), generator=gen, device="cuda")
    a16, b16 = a.bfloat16(), b.bfloat16()
    times = {}
    for name in good + good[::-1]:
        _build.load_library = lambda lib=libs[name]: lib
        for tile in tiles:
            for dt, x, y, reps in (("f32", a, b, 2), ("bf16", a16, b16, 3)):
                times.setdefault((name, dt, tile), []).append(cuda_ms(
                    torch, lambda: pk.pallas_matmul(x, y, *tile), reps))
    for (name, dt, tile), ms in sorted(times.items()):
        print(f"{name} {dt} {tile}: " + " ".join(f"{t:.3f}" for t in ms)
              + " ms")
    print(f"torch.matmul f32 {cuda_ms(torch, lambda: torch.matmul(a, b), 2):.3f}"
          f" ms, bf16 {cuda_ms(torch, lambda: torch.matmul(a16, b16), 3):.3f} ms")
    return 0 if len(good) == len(jobs) else 1


if __name__ == "__main__":
    sys.exit(main())
