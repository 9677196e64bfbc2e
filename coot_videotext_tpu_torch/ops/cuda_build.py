"""
Build, load and count the package's hand-written CUDA kernels.

The sources in `coot_videotext_tpu_torch/csrc/*.cu` expose a plain C
interface. At first use they are compiled for Hopper (`sm_90a`) with `nvcc`,
one process per source, all started together, and linked into one shared
library under `build/kernels/<hash>/` (the hash covers the sources and the
flags, so an edited source is rebuilt). The library is loaded with `ctypes`;
nothing here includes PyTorch's headers, which keeps the build to seconds.

Every C entry launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises when that is not 0. `launch_counts`
counts wrapper calls that launched a kernel of B1-B6, by kernel name; a
backward counts under `<name>_bwd` (the train steps' phase marks,
ops/phase.py, are not counted).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("input_fc.cu", "genpool.cu", "attention.cu", "dropout.cu",
           "gather.cu", "coot_norm.cu", "phase.cu")
HEADERS = ("common.cuh", "mma.cuh", "philox.cuh", "tn_mma.cuh",
           "tn_reduce.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernels (if not built yet) and return the .so path.
    The compiler's register and spill report goes to `build.log` beside
    the library. Processes that build at once (the ranks of a
    data-parallel run on a fresh checkout) compile into directories of
    their own and each moves a whole library into place."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / "libcoot_kernels.so"
    if lib.is_file():
        return lib
    work = out_dir / f"work{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c",
               str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for name, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"===== {name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    (work / "build.log").write_text("\n".join(log), encoding="utf8")
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = work / "libcoot_kernels.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)]
        + [str(obj) for _, obj, _ in procs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(work / "build.log", out_dir / "build.log")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_SIGNATURES = {
    # x, gain, bias, w, b, y, mean, inv, pre, S, din, dout, eps, act, bf16,
    # stream
    "coot_input_fc_fwd": [_P] * 9 + [_I, _I, _I, _F, _I, _I, _P],
    # x, gain, bias, w, mean, inv, pre, dy, dpre, scratch, unit, dw, db,
    # dgain, dbias, S, din, dout, act, splits, dpre splits, bf16, stream
    "coot_input_fc_bwd": [_P] * 15 + [_I] * 7 + [_P],
    # f, mask, w1, b1, w2, b2, out, stats, logits scratch, S, L, D, H,
    # heads, act, seed state, call, thresh, drop scale, bf16, stream
    "coot_genpool_fwd": [_P] * 9 + [_I, _I, _I, _I, _I, _I, _P, _U, _U, _F,
                                    _I, _P],
    # f, mask, w1, b1, w2, b2, stats, dout, df, h1, dpre, dh2, fac, scratch,
    # dw1, db1, dw2, db2, S, L, D, H, heads, act, seed state, call, thresh,
    # drop scale, splits, splits2, bf16, stream
    "coot_genpool_bwd": [_P] * 18 + [_I, _I, _I, _I, _I, _I, _P, _U, _U, _F,
                                     _I, _I, _I, _P],
    # q, k, v, key_valid, o, row_max, row_inv, N, Lq, Lk, Dh, num_heads,
    # scale, seed state, call, thresh, drop scale, bq, bk, cells, bf16,
    # stream
    "coot_attention_fwd": [_P] * 7 + [_I, _I, _I, _I, _I, _F, _P, _U, _U, _F,
                                      _I, _I, _I, _I, _P],
    # q, k, v, o, g, key_valid, row_max, row_inv, dq, dk, dv, dq scratch,
    # D scratch, N, Lq, Lk, Dh, num_heads, scale, seed state, call,
    # thresh, drop scale, bf16, stream
    "coot_attention_bwd": [_P] * 13 + [_I, _I, _I, _I, _I, _F, _P, _U, _U,
                                       _F, _I, _P],
    # x, y, n, seed state, call, thresh, scale, site, bf16, stream
    "coot_dropout": [_P, _P, _LL, _P, _U, _U, _F, _U, _I, _P],
    # table, idx, out, n, t, row bytes, seed state, call, site, std, lo,
    # span, bf16, stream
    "coot_gather_rows": [_P, _P, _P, _LL, _LL, _LL, _P, _U, _U, _F, _F, _F,
                         _I, _P],
    # y, residual, gain, bias, out, sum, mean, inv, N, D, eps, bf16, stream
    "coot_norm_fwd": [_P] * 8 + [_I, _I, _F, _I, _P],
    # dout, s, mean, inv, gain, dx, scratch, dgain and dbias, N, D, blocks,
    # bf16, stream
    "coot_norm_bwd": [_P] * 8 + [_I] * 4 + [_P],
    # phase, stream
    "coot_phase_mark": [_I, _P],
}


def splits_for(rows: int, tiles: int) -> int:
    """Row splits of a weight-gradient reduction (csrc/tn_reduce.cuh):
    about 2048 blocks over the output tiles, at least 256 rows per split,
    at most 64 splits."""
    return max(1, min(64, -(-2048 // max(tiles, 1)), rows // 256))


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build on first use and load; one library per process."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream(t) -> int:
    """The current CUDA stream of t's device, as the C entries take it:
    the raw handle, as PyTorch's own kernel launchers read it, without
    building a torch.cuda.Stream object on every launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
