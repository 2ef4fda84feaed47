"""Forward HBFP matmul on Hopper: the wrapper of `csrc/hbfp_matmul_fwd.cu`
(port of `repro.kernels.hbfp_matmul.hbfp_matmul_pallas`).

    y[M,N] = Σ_kb Q_row(x)[M,bk] · (Q_tile(w) or narrow w)[bk,bn] · δx(·δw)

The CUDA source is compiled with `nvcc` at first use into
`build/repro_torch/` (a plain C entry point loaded with ctypes), never at
import, so the CPU tests import this module freely. `hbfp_matmul_fwd`
launches the kernel for CUDA tensors and raises if it cannot; for CPU
tensors it computes the plain version `hbfp_matmul_plain`
(`kernels/ref.py`). Nothing falls back from the card to the plain version.

Counters: `hbfp_matmul_fwd.launches` counts kernel launches and
`hbfp_matmul_fwd.plain_calls` counts CPU calls of the plain version made by
the wrapper (`reset_counts()` zeroes both).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

from repro_torch.kernels.ref import hbfp_matmul_ref as hbfp_matmul_plain

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "hbfp_matmul_fwd.cu")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_ROOT, "build", "repro_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPES = (torch.float32, torch.bfloat16)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(source: str = SOURCE) -> str:
    """Build output for `source`, named by the hash of its contents so an
    edited source never loads a stale library."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


class _Library:
    """The loaded kernel library (loaded once per process)."""

    def __init__(self):
        self.lib = None

    def load(self, path: Optional[str] = None):
        if self.lib is not None:
            return self.lib
        if path is None:
            path = library_path()
            if not os.path.exists(path):
                path = build()["path"]
        lib = ctypes.CDLL(path)
        fn = lib.hbfp_matmul_fwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        self.lib = lib
        return lib


_LIB = _Library()


def build(source: str = SOURCE) -> dict:
    """Compile `source` with nvcc now; returns {path, seconds, log} with
    the `-Xptxas -v` register/spill report in `log`. Raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(source)
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", source],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
    os.replace(out + ".tmp", out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": r.stdout + r.stderr}


def load(path: Optional[str] = None):
    """Load the kernel library from `path`, or from its build output,
    building it first when that is missing."""
    return _LIB.load(path)


def reset_counts() -> None:
    hbfp_matmul_fwd.launches = 0
    hbfp_matmul_fwd.plain_calls = 0


def _seed_int(seed) -> int:
    if seed is None:
        return 0
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    seed = int(seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= (1 << 31) else seed


def hbfp_matmul_fwd(x: torch.Tensor, w: torch.Tensor, seed=None, *,
                    mantissa_bits: int = 8, stochastic: bool = False,
                    quantize_w: bool = True, block: int = 0,
                    bm: int = 128, bk: int = 128,
                    bn: int = 128) -> torch.Tensor:
    """Fused quantize + matmul. x: [M,K] f32/bf16, w: [K,N] f32/bf16, both
    contiguous on one device and divisible by the clipped tiles (the
    caller pads, `kernels/linear.py`). Returns y [M,N] f32."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} x {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"dtypes {x.dtype}, {w.dtype} not in {_DTYPES}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    bm, bk, bn = min(bm, M), min(bk, K), min(bn, N)
    if M % bm or K % bk or N % bn:
        raise ValueError(f"({M},{K})x({K},{N}) not divisible by "
                         f"({bm},{bk},{bn})")
    if block and (bk % min(block, bk) or bn % min(block, bn)):
        raise ValueError(f"block {block} must divide tiles ({bk},{bn})")
    kw = dict(mantissa_bits=mantissa_bits, stochastic=stochastic,
              quantize_w=quantize_w, block=block, bm=bm, bk=bk, bn=bn)
    if x.device.type == "cpu":
        hbfp_matmul_fwd.plain_calls += 1
        return hbfp_matmul_plain(x, w, seed, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not 2 <= mantissa_bits <= 12:
        raise ValueError(f"the CUDA kernel takes 2 <= m <= 12, got "
                         f"{mantissa_bits}")
    lib = load()
    dev = x.device
    x_sub = bool(block) and block < bk
    w_sub = bool(block) and (block < bk or block < bn)
    gx = block if x_sub else bk
    gk, gn = (min(block, bk), min(block, bn)) if w_sub else (bk, bn)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((M, N), **f32)
    xq = torch.empty((M, K), **f32)
    sx = torch.empty((M, K // gx), **f32)
    if quantize_w:
        wq = torch.empty((K, N), **f32)
        sw = torch.empty((K // gk, N // gn), **f32)
    else:
        wq = sw = None
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hbfp_matmul_fwd(
            x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            int(w.dtype == torch.bfloat16), y.data_ptr(), xq.data_ptr(),
            sx.data_ptr(), ptr(wq), ptr(sw), M, K, N, bk, bn,
            mantissa_bits, int(stochastic), int(quantize_w), int(block),
            _seed_int(seed), stream)
    if rc != 0:
        raise RuntimeError(f"hbfp_matmul_fwd launch failed: CUDA error {rc}")
    hbfp_matmul_fwd.launches += 1
    return y


reset_counts()
