"""HBFP GEMMs on Hopper: the wrappers of `csrc/hbfp_matmul_fwd.cu` (B1,
port of `repro.kernels.hbfp_matmul.hbfp_matmul_pallas`) and
`csrc/hbfp_matmul_bwd.cu` (B2 `hbfp_dgrad_pallas`, B3
`hbfp_wgrad_pallas`).

    y [M,N] = Σ_kb Q_row(x)[M,bk] · (Q_tile(w) or narrow w)[bk,bn] · δx(·δw)
    dx[M,K] = Σ_nb Q_row(g)[M,bn] · (Q_tile(w) or narrow w)[bk,bn]ᵀ · δg(·δw)
    dw[K,N] = Σ_m  (Q_row(x)·δx)[m,K]ᵀ (Q_row(g)·δg)[m,N]

Each CUDA source (with the shared headers `csrc/hbfp_common.cuh` and
`csrc/hbfp_gemm_sm90.cuh`) is compiled with `nvcc` at first use into
`build/repro_torch/` (a plain C entry point loaded with ctypes), never at
import, so the CPU tests import this module freely. A wrapper launches its
kernel for CUDA tensors and raises if it cannot; for CPU tensors it
computes the plain version (`kernels/ref.py`). Nothing falls back from the
card to the plain version.

Routes of B1 and B2 (`gemm_route`, which the C side's `tc_route`
mirrors): "int8_wgmma" (weights quantized in the kernel, no sub-tile
groups, m <= 8: every training call), "bf16_wgmma" (bf16 weights taken as
stored, no activation sub-groups, m <= 8: serving, prefill, the adaptive
path after a widen) and "cuda_core" (everything else: m 9-12, block > 0,
f32 raw weights). A route is chosen by the call's arithmetic, never
retried on another; `gemm_scratch` gives each route's scratch.

Routes of B3 (`wgrad_route`, which the C side's `wgrad_route` in
`csrc/hbfp_matmul_bwd.cu` mirrors): "bf16_wgmma" (m <= 8, M-blocks of
64-token multiples, 16-byte rows: every training call, block > 0
included, since the dequantized operands are exact in bf16 whatever
their exponent groups) and "cuda_core" (m 9-12, other tiles);
`wgrad_scratch` gives their scratch.

Row amax (tensor parallelism): B1 takes `x_amax`, B2 `g_amax`, B3 both,
each None or the activation operand's f32 group amaxes, [M] when a row
is one exponent group, else [M, C/group] in the order of the row pass's
scales. The row pass of every route (`quantize_rows_kernel` in
`csrc/hbfp_common.cuh`, the pre-pass of the tensor-core routes too)
quantizes on the given amax instead of its own: a rank that holds part
of each row quantizes it on the global row max, all-reduced (MAX) over
the model group, and gets the one-process mantissas and exponents. An
amax equal to the group's own max gives the same bits as None.

Index bases (stochastic rounding under a mesh): B1 takes `x_base`,
`w_base`, B2 `g_base`, `w_base`, B3 `x_base`, `g_base`, each None (the
operand is the whole one-process operand) or a 2-D
`kernels.common.IndexBase` (`flat_base`) on the padded one-process
operand: the part's (row, column) offset and that operand's padded row
length. Every route's quantize passes (`quantize_rows_kernel`,
`quantize_w_kernel` in `csrc/hbfp_common.cuh`) draw element (r, c) at
(row_off + r)·ld + col_off + c, so a data shard, a tensor-parallel column
or row block, draws one process's numbers. The base goes to the kernel
as given, never dropped, and the plain version takes the same one.

Counters: each wrapper's `.launches` counts kernel launches,
`.launches_by_route` the same launches by route, and
`.plain_calls` counts CPU calls of its plain version (`reset_counts()`
zeroes all of them).
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

from repro_torch.kernels.ref import hbfp_dgrad_ref as hbfp_dgrad_plain
from repro_torch.kernels.ref import hbfp_matmul_ref as hbfp_matmul_plain
from repro_torch.kernels.ref import hbfp_wgrad_ref as hbfp_wgrad_plain

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
HEADERS = (os.path.join(_CSRC, "hbfp_common.cuh"),
           os.path.join(_CSRC, "hbfp_gemm_sm90.cuh"),
           os.path.join(_CSRC, "hbfp_flash_fwd_sm90.cuh"),
           os.path.join(_CSRC, "hbfp_flash_bwd_sm90.cuh"))
# library name -> source; each library's entry points and their ctypes
# argument kinds ("p" pointer, "i" int, "f" float)
SOURCES = {"hbfp_matmul_fwd": os.path.join(_CSRC, "hbfp_matmul_fwd.cu"),
           "hbfp_matmul_bwd": os.path.join(_CSRC, "hbfp_matmul_bwd.cu"),
           "hbfp_flash_attn": os.path.join(_CSRC, "hbfp_flash_attn.cu"),
           "bfp_quantize": os.path.join(_CSRC, "bfp_quantize.cu")}
_ENTRIES = {
    "hbfp_matmul_fwd": {"hbfp_matmul_fwd": "pipip" + "p" * 7 + "i" * 16
                        + "pp"},
    "hbfp_matmul_bwd": {"hbfp_dgrad": "pipip" + "p" * 7 + "i" * 16 + "pp",
                        "hbfp_wgrad": "pipip" + "p" * 7 + "i" * 16 + "ppp"},
    "hbfp_flash_attn": {"hbfp_flash_fwd": "pppipp" + "p" * 6 + "i" * 8
                        + "fp",
                        "hbfp_flash_dq": "ppppppip" + "p" * 9 + "i" * 8
                        + "fp",
                        "hbfp_flash_dkv": "ppppppipp" + "p" * 10 + "i" * 8
                        + "fp"},
    "bfp_quantize": {"bfp_quantize": "pipi" + "p" * 5 + "i" * 24 + "p"},
}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_ROOT, "build", "repro_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# cuTensorMapEncodeTiled (the TMA descriptors) is a driver-API symbol
NVCC_LIBS = ("-lcuda",)

_DTYPES = (torch.float32, torch.bfloat16)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> str:
    """Build output of library `name`, named by the hash of its source and
    every shared header so an edited source never loads a stale
    library."""
    h = hashlib.sha1()
    for path in (SOURCES[name], *HEADERS):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> dict:
    """Compile library `name` with nvcc now; returns {path, seconds, log}
    with the `-Xptxas -v` register/spill report in `log`. Raises on
    failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp",
                        SOURCES[name], *NVCC_LIBS], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(out + ".tmp", out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": r.stdout + r.stderr}


_LIBS: dict = {}


def load(name: str, path: Optional[str] = None):
    """Load library `name` (once per process) from `path`, or from its
    build output, building it first when that is missing."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if path is None:
        path = library_path(name)
        if not os.path.exists(path):
            path = build(name)["path"]
    lib = ctypes.CDLL(path)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for entry, sig in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = [kinds[c] for c in sig]
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


ROUTES = ("int8_wgmma", "bf16_wgmma", "cuda_core")
SMS = 132          # H100 SXM; the C side's kSMs
SMALL_M = 64       # M at or below: one warpgroup and split K-blocks
CTA_N = 128        # output columns of a tensor-core CTA


def reset_counts() -> None:
    for fn in (hbfp_matmul_fwd, hbfp_dgrad, hbfp_wgrad):
        fn.launches = 0
        fn.plain_calls = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


def gemm_route(op: str, *, mantissa_bits: int, quantize_w: bool,
               block: int, bk: int, bn: int, N: int,
               w_dtype: torch.dtype) -> str:
    """The route of one B1 (op "fwd") or B2 (op "dgrad") launch at the
    clipped tiles (bk, bn), as the C side's `tc_route` takes it: the
    contraction block must be a whole number of the tensor-core kernel's
    128-byte stages (128 int8 or 64 bf16 values), w's scale groups whole
    8-column fragments (int8), and the forward's stored bf16 w rows
    16-byte multiples for TMA."""
    cblk, oblk = (bk, bn) if op == "fwd" else (bn, bk)
    a_sub = bool(block) and block < cblk
    w_sub = bool(block) and (block < bk or block < bn)
    if mantissa_bits > 8:
        return "cuda_core"
    if quantize_w and not (a_sub or w_sub) and cblk % 128 == 0 \
            and oblk % 8 == 0:
        return "int8_wgmma"
    if not quantize_w and not a_sub and w_dtype == torch.bfloat16 \
            and cblk % 64 == 0 and (op == "dgrad" or N % 8 == 0):
        return "bf16_wgmma"
    return "cuda_core"


def decode_splits(M: int, n_out: int, n_blocks: int) -> int:
    """How many CTAs share the contraction of a tensor-core launch (the C
    side's `decode_splits`): 1 above SMALL_M rows or when the output tiles
    fill the card, else enough K-range splits of whole blocks for two
    waves."""
    if M > SMALL_M:
        return 1
    ctas = -(-n_out // CTA_N)
    if ctas >= SMS:
        return 1
    want = min(n_blocks, -(-2 * SMS // ctas))
    per = -(-n_blocks // want)
    return -(-n_blocks // per)


def gemm_scratch(op: str, route: str, M: int, K: int, N: int, *, bk: int,
                 bn: int, block: int, quantize_w: bool) -> dict:
    """Scratch of one B1/B2 launch, {name: (shape, dtype) or None}, in
    the C entry point's argument order (xq, sx, wq, sw, xq8, wq8, part):
    the quantized activation rows (x for fwd, g for dgrad) and their
    scales, w's quantized tiles and scales, and the split partials."""
    f32 = torch.float32
    cblk, C, O = (bk, K, N) if op == "fwd" else (bn, N, K)
    a_sub = bool(block) and block < cblk
    w_sub = bool(block) and (block < bk or block < bn)
    ga = block if a_sub else cblk
    gk, gn = (min(block, bk), min(block, bn)) if w_sub else (bk, bn)
    out = dict.fromkeys(("xq", "sx", "wq", "sw", "xq8", "wq8", "part"))
    out["sx"] = ((M, C // ga), f32)
    if route == "cuda_core":
        out["xq"] = ((M, C), f32)
        if quantize_w:
            out["wq"] = ((K, N), f32)
            out["sw"] = ((K // gk, N // gn), f32)
        return out
    i8 = route == "int8_wgmma"
    out["xq8"] = ((M, C), torch.int8 if i8 else torch.bfloat16)
    if i8:
        out["wq8"] = ((N, K) if op == "fwd" else (K, N), torch.int8)
        out["sw"] = ((K // bk, N // bn), f32)
    if decode_splits(M, O, C // cblk) > 1:
        out["part"] = ((C // cblk, M, O), f32)
    return out


def wgrad_route(*, mantissa_bits: int, M: int, K: int, N: int,
                bm: int) -> str:
    """The route of one B3 launch at the clipped M-block bm, as the C
    side's `wgrad_route` takes it: bf16 wgmma where the dequantized
    operands are exact in bf16 (m <= 8), the M-block is a whole number of
    the tensor-core kernel's 64-token stages and x̂'s and ĝ's rows are
    16-byte multiples for TMA; else the CUDA cores."""
    if mantissa_bits <= 8 and bm % 64 == 0 and M % bm == 0 and K % 8 == 0 \
            and N % 8 == 0:
        return "bf16_wgmma"
    return "cuda_core"


def wgrad_scratch(route: str, M: int, K: int, N: int, *, bm: int, bk: int,
                  bn: int, block: int) -> dict:
    """Scratch of one B3 launch, {name: (shape, dtype) or None}, in the C
    entry point's argument order (xq, sx, gq, sg, xh, gh, part): the
    dequantized operands in f32 (cuda_core) or bf16 (bf16_wgmma), their
    group scales, and the split partials of an M-block split (K <= 64)."""
    f32 = torch.float32
    gx = block if (block and block < bk) else bk
    gg = block if (block and block < bn) else bn
    out = dict.fromkeys(("xq", "sx", "gq", "sg", "xh", "gh", "part"))
    out["sx"] = ((M, K // gx), f32)
    out["sg"] = ((M, N // gg), f32)
    if route == "cuda_core":
        out["xq"] = ((M, K), f32)
        out["gq"] = ((M, N), f32)
        return out
    out["xh"] = ((M, K), torch.bfloat16)
    out["gh"] = ((M, N), torch.bfloat16)
    if decode_splits(K, N, M // bm) > 1:
        out["part"] = ((M // bm, K, N), f32)
    return out


def _row_group(block: int, cblk: int) -> int:
    """Columns of one exponent group of an activation row in a launch
    whose contraction block (or output block, for B3's g) is `cblk`."""
    return block if block and block < cblk else cblk


def _seed_int(seed) -> int:
    if seed is None:
        return 0
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    seed = int(seed) & 0xFFFFFFFF
    return seed - (1 << 32) if seed >= (1 << 31) else seed


def _check(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    """Shared operand checks: 2-D, one device, supported dtypes,
    contiguous."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"{what}: bad shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands on {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtypes {a.dtype}, {b.dtype} not in "
                        f"{_DTYPES}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")


def _tiles(what: str, M: int, K: int, N: int, bm: int, bk: int, bn: int,
           block: int):
    bm, bk, bn = min(bm, M), min(bk, K), min(bn, N)
    if M % bm or K % bk or N % bn:
        raise ValueError(f"{what}: (M,K,N)=({M},{K},{N}) not divisible by "
                         f"({bm},{bk},{bn})")
    if block and (bk % min(block, bk) or bn % min(block, bn)):
        raise ValueError(f"{what}: block {block} must divide tiles "
                         f"({bk},{bn})")
    return bm, bk, bn


def _launchable(t: torch.Tensor, mantissa_bits: int, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if not 2 <= mantissa_bits <= 12:
        raise ValueError(f"{what}: the CUDA kernel takes 2 <= m <= 12, got "
                         f"{mantissa_bits}")


def _amax_arg(amax: Optional[torch.Tensor], M: int, C: int, group: int,
              dev: torch.device, what: str):
    """The pointer of a row-amax operand (None: the kernel's own amax):
    f32, contiguous, on the operands' device, M·(C/group) values."""
    if amax is None:
        return None
    if amax.dtype != torch.float32 or not amax.is_contiguous() \
            or amax.device != dev or amax.numel() != M * (C // group):
        raise ValueError(f"{what}: the row amax must be a contiguous f32 "
                         f"tensor of {M} x {C // group} values on {dev}, got "
                         f"{amax.dtype} {tuple(amax.shape)} on {amax.device}")
    return amax.data_ptr()


def base_args(base, cols: int) -> tuple:
    """(row_off, col_off, ld) of a 2-D `IndexBase` for an operand whose
    padded rows are `cols` long (None: the whole operand, (0, 0, cols)),
    as the entry points take it; checked so that every value fits the C
    side's int."""
    if base is None:
        return 0, 0, int(cols)
    if len(base.shape) != 2:
        raise ValueError(f"the kernels take a 2-D index base, got {base}")
    (row, col), ld = base.offset, base.shape[1]
    if min(row, col) < 0 or col + cols > ld or max(row, ld) >= 1 << 31:
        raise ValueError(f"index base {base} for rows of {cols}")
    return int(row), int(col), int(ld)


def _launch(lib_name: str, entry: str, dev: torch.device, *args) -> None:
    fn = getattr(load(lib_name), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _gemm_launch(op: str, lib_entry: str, a: torch.Tensor, w: torch.Tensor,
                 out: torch.Tensor, seed, M: int, K: int, N: int, *,
                 mantissa_bits: int, stochastic: bool, quantize_w: bool,
                 block: int, bk: int, bn: int, amax=None, a_base=None,
                 w_base=None) -> str:
    """Allocate the route's scratch and launch B1 or B2 (`amax` the row
    amax pointer of its activation operand, or None; `a_base`, `w_base`
    the operands' index bases); returns the route."""
    route = gemm_route(op, mantissa_bits=mantissa_bits,
                       quantize_w=quantize_w, block=block, bk=bk, bn=bn, N=N,
                       w_dtype=w.dtype)
    scratch = {k: None if v is None else
               torch.empty(v[0], dtype=v[1], device=a.device)
               for k, v in gemm_scratch(op, route, M, K, N, bk=bk, bn=bn,
                                        block=block,
                                        quantize_w=quantize_w).items()}
    lib = "hbfp_matmul_fwd" if op == "fwd" else "hbfp_matmul_bwd"
    _launch(lib, lib_entry, a.device, a.data_ptr(), _is_bf16(a),
            w.data_ptr(), _is_bf16(w), out.data_ptr(),
            *(_ptr(t) for t in scratch.values()), M, K, N, bk, bn,
            mantissa_bits, int(stochastic), int(quantize_w), int(block),
            _seed_int(seed), *base_args(a_base, a.shape[1]),
            *base_args(w_base, N), amax)
    return route


def hbfp_matmul_fwd(x: torch.Tensor, w: torch.Tensor, seed=None, *,
                    mantissa_bits: int = 8, stochastic: bool = False,
                    quantize_w: bool = True, block: int = 0,
                    bm: int = 128, bk: int = 128,
                    bn: int = 128, x_amax: Optional[torch.Tensor] = None,
                    x_base=None, w_base=None) -> torch.Tensor:
    """B1, fused quantize + matmul. x: [M,K] f32/bf16, w: [K,N] f32/bf16,
    both contiguous on one device and divisible by the clipped tiles (the
    caller pads, `kernels/linear.py`); `x_amax` x's row amax, `x_base`,
    `w_base` the operands' index bases (module doc). Returns y [M,N]
    f32."""
    _check(x, w, "hbfp_matmul_fwd")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} x {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    bm, bk, bn = _tiles("hbfp_matmul_fwd", M, K, N, bm, bk, bn, block)
    kw = dict(mantissa_bits=mantissa_bits, stochastic=stochastic,
              quantize_w=quantize_w, block=block, bm=bm, bk=bk, bn=bn)
    base_args(x_base, K), base_args(w_base, N)             # checked here
    if x.device.type == "cpu":
        hbfp_matmul_fwd.plain_calls += 1
        return hbfp_matmul_plain(x, w, seed, x_amax=x_amax, x_base=x_base,
                                 w_base=w_base, **kw)
    _launchable(x, mantissa_bits, "hbfp_matmul_fwd")
    amax = _amax_arg(x_amax, M, K, _row_group(block, bk), x.device,
                     "hbfp_matmul_fwd")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    route = _gemm_launch("fwd", "hbfp_matmul_fwd", x, w, y, seed, M, K, N,
                         mantissa_bits=mantissa_bits, stochastic=stochastic,
                         quantize_w=quantize_w, block=block, bk=bk, bn=bn,
                         amax=amax, a_base=x_base, w_base=w_base)
    hbfp_matmul_fwd.launches += 1
    hbfp_matmul_fwd.launches_by_route[route] += 1
    return y


def hbfp_dgrad(g: torch.Tensor, w: torch.Tensor, seed=None, *,
               mantissa_bits: int = 8, stochastic: bool = False,
               quantize_w: bool = True, block: int = 0,
               bm: int = 128, bk: int = 128, bn: int = 128,
               g_amax: Optional[torch.Tensor] = None, g_base=None,
               w_base=None) -> torch.Tensor:
    """B2, dx[M,K] = Q(g)[M,N] · Q(w)[K,N]ᵀ. g: [M,N] f32/bf16, w: [K,N]
    f32/bf16 as stored, contiguous, divisible by the clipped tiles (bm over
    M, bk over K, bn over the contracted N); `g_amax` g's row amax,
    `g_base`, `w_base` the operands' index bases. Returns dx [M,K] f32."""
    _check(g, w, "hbfp_dgrad")
    if g.shape[1] != w.shape[1]:
        raise ValueError(f"dgrad: bad shapes {tuple(g.shape)}, "
                         f"{tuple(w.shape)}")
    M, N = g.shape
    K = w.shape[0]
    bm, bk, bn = _tiles("hbfp_dgrad", M, K, N, bm, bk, bn, block)
    kw = dict(mantissa_bits=mantissa_bits, stochastic=stochastic,
              quantize_w=quantize_w, block=block, bm=bm, bk=bk, bn=bn)
    base_args(g_base, N), base_args(w_base, N)             # checked here
    if g.device.type == "cpu":
        hbfp_dgrad.plain_calls += 1
        return hbfp_dgrad_plain(g, w, seed, g_amax=g_amax, g_base=g_base,
                                w_base=w_base, **kw)
    _launchable(g, mantissa_bits, "hbfp_dgrad")
    amax = _amax_arg(g_amax, M, N, _row_group(block, bn), g.device,
                     "hbfp_dgrad")
    dx = torch.empty((M, K), dtype=torch.float32, device=g.device)
    route = _gemm_launch("dgrad", "hbfp_dgrad", g, w, dx, seed, M, K, N,
                         mantissa_bits=mantissa_bits, stochastic=stochastic,
                         quantize_w=quantize_w, block=block, bk=bk, bn=bn,
                         amax=amax, a_base=g_base, w_base=w_base)
    hbfp_dgrad.launches += 1
    hbfp_dgrad.launches_by_route[route] += 1
    return dx


def hbfp_wgrad(x: torch.Tensor, g: torch.Tensor, seed=None, *,
               mantissa_bits: int = 8, stochastic: bool = False,
               block: int = 0, bm: int = 128, bk: int = 128,
               bn: int = 128, operands: bool = False,
               x_amax: Optional[torch.Tensor] = None,
               g_amax: Optional[torch.Tensor] = None, x_base=None,
               g_base=None):
    """B3, dw[K,N] = (Q(x)·δx)[M,K]ᵀ · (Q(g)·δg)[M,N]. x: [M,K], g: [M,N],
    f32/bf16, contiguous, divisible by the clipped tiles (bm over the
    contracted M, bk over K, bn over N); `x_amax`, `g_amax` the operands'
    row amaxes, `x_base`, `g_base` their index bases. Returns dw [K,N]
    f32, or (dw, x̂, ĝ) with the dequantized operands (f32) when
    `operands` is set."""
    _check(x, g, "hbfp_wgrad")
    if x.shape[0] != g.shape[0]:
        raise ValueError(f"wgrad: bad shapes {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    M, K = x.shape
    N = g.shape[1]
    bm, bk, bn = _tiles("hbfp_wgrad", M, K, N, bm, bk, bn, block)
    kw = dict(mantissa_bits=mantissa_bits, stochastic=stochastic,
              block=block, bm=bm, bk=bk, bn=bn, operands=operands)
    bases = (*base_args(x_base, K), *base_args(g_base, N))
    if x.device.type == "cpu":
        hbfp_wgrad.plain_calls += 1
        return hbfp_wgrad_plain(x, g, seed, x_amax=x_amax, g_amax=g_amax,
                                x_base=x_base, g_base=g_base, **kw)
    _launchable(x, mantissa_bits, "hbfp_wgrad")
    amaxes = (_amax_arg(x_amax, M, K, _row_group(block, bk), x.device,
                        "hbfp_wgrad"),
              _amax_arg(g_amax, M, N, _row_group(block, bn), x.device,
                        "hbfp_wgrad"))
    route = wgrad_route(mantissa_bits=mantissa_bits, M=M, K=K, N=N, bm=bm)
    scratch = {k: None if v is None else
               torch.empty(v[0], dtype=v[1], device=x.device)
               for k, v in wgrad_scratch(route, M, K, N, bm=bm, bk=bk,
                                         bn=bn, block=block).items()}
    dw = torch.empty((K, N), dtype=torch.float32, device=x.device)
    _launch("hbfp_matmul_bwd", "hbfp_wgrad", x.device,
            x.data_ptr(), _is_bf16(x), g.data_ptr(), _is_bf16(g),
            dw.data_ptr(), *(_ptr(t) for t in scratch.values()), M, K, N,
            bm, bk, bn, mantissa_bits, int(stochastic), int(block),
            _seed_int(seed), *bases, *amaxes)
    hbfp_wgrad.launches += 1
    hbfp_wgrad.launches_by_route[route] += 1
    if not operands:
        return dw
    xh, gh = (scratch["xq"], scratch["gq"]) if route == "cuda_core" else \
        (scratch["xh"].float(), scratch["gh"].float())
    return dw, xh, gh


reset_counts()
