"""Hand-written CUDA kernels of the port, their builds and their wrappers.

The counterpart of ``karpenter_tpu/ops/pallas_kernels.py``. Each kernel
sits beside its plain PyTorch version:

- ``compat`` — requirement compatibility ``[G,T]`` of group rows against
  type (or template) rows over K keys of W mask words
  (``csrc/compat.cu``, replacing ``compat_pallas``, which only took W=1).
  ``compat_reference`` is its plain version; ``compat_tile`` picks the
  kernel's tile for a shape; ``compat_noop`` launches the source's empty
  kernel, the floor any launch pays.

A wrapper given CPU tensors runs the plain version — that is the port's
CPU path and what the tests run. Given CUDA tensors it launches the kernel
or raises; it never falls back to the plain version.

Kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers), loaded with
``ctypes``. Builds land in ``build/torch_kernels/`` at the repository root,
named by a hash of the source and flags, so an edited source rebuilds.
``LAUNCHES`` counts each kernel launch (only launches, not plain-version
calls), so a run can show that its path went through the kernels.

A kernel that does not build or launch raises :class:`KernelError`.
``DEVICE_FAULTS`` is that class, ``OSError`` (a kernel library that does
not load) and torch's own CUDA errors: the faults a caller that falls back
on host-side errors must let through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from karpenter_tpu_torch.utils.envknobs import env_str

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# kernel name -> source file under csrc/
SOURCES = {"compat": "compat.cu"}

LAUNCHES = {name: 0 for name in SOURCES}
# ptxas register/shared-memory report of each build, by kernel name
BUILD_LOGS: dict = {}
_LIBS: dict = {}


class KernelError(RuntimeError):
    """A kernel of the port did not build or launch."""


DEVICE_FAULTS = (KernelError, OSError, torch.cuda.OutOfMemoryError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = env_str("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise KernelError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are compiled at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None) -> dict:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    ``{name: library path}``; raises with the compiler's output if a build
    fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "compat":
            lib.karpenter_compat.argtypes = [ctypes.c_char_p]
            lib.karpenter_compat.restype = ci
            lib.karpenter_compat_noop.argtypes = [vp]
            lib.karpenter_compat_noop.restype = ci
        lib.karpenter_cuda_error_string.argtypes = [ci]
        lib.karpenter_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.karpenter_cuda_error_string(rc).decode()
        raise KernelError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def _stream(index: int) -> int:
    """The raw handle of the current stream on CUDA device ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


# H100: streaming multiprocessors, and the largest dynamic shared memory
# one block may take
_SMS = 132
_MAX_SMEM = 232448
# a compat block keeps under this much shared memory when the key axis can
# be streamed in chunks (two blocks fit on an SM)
_SMEM_BUDGET = 112 * 1024
# pairs at or above which a thread takes a 4 × 4 register tile of pairs
# (16 per thread with 256 threads on every SM)
_TILE_PAIRS = _SMS * 256 * 16
# the launch arguments of csrc/compat.cu's karpenter_compat (CompatArgs):
# seven pointers, G, T, K, W, the tile (tt, tg, rg, rt, kc, threads,
# smem), the device index and the stream, packed into one buffer
_COMPAT_ARGS = struct.Struct("<20q")


class CompatTile(NamedTuple):
    tt: int  # types per block
    tg: int  # group rows per block
    rg: int  # group rows per thread
    rt: int  # types per thread
    kc: int  # keys per shared-memory chunk
    threads: int  # threads per block, >= the (tt // rt) * (tg // rg) testing pairs
    grid: tuple  # (blocks along T, blocks along G)
    smem: int  # dynamic shared memory bytes per block


def _compat_smem(tt: int, tg: int, kc: int, K: int, W: int) -> int:
    """Bytes of dynamic shared memory of one compat block (csrc/compat.cu's
    layout, with the 16-byte path's row padding: the larger of the two)."""
    kcw = kc * W
    stride = (kcw + 7) // 8 * 8 + 4
    words = (tt + tg) * stride + kcw + 2 * kc + 3
    byte_run = lambda n: (n * K + 30) // 16 * 16  # noqa: E731
    return (-(-4 * words // 16) * 16 + 2 * byte_run(tg) + 2 * byte_run(tt)
            + kcw + kc)


@functools.lru_cache(maxsize=512)
def compat_tile(G: int, T: int, K: int, W: int) -> CompatTile:
    """The compat kernel's tile for one shape (G, T >= 1). One (g,t) pair
    per thread, or 4 group rows × 4 types per thread once the pairs fill
    every SM 16 times over; block size 64-256 threads so the grid covers
    the SMs; 32 threads along T (a warp shares its group rows and writes
    neighbouring output bytes) unless T is smaller or G too small to fill
    the block; 256 threads per block when the grid leaves SMs idle (the
    extra threads only stage rows); as many keys per shared-memory chunk
    as fit the budget. Raises if one key of the smallest tile does not
    fit in shared memory."""
    rg = rt = 4 if G * T >= _TILE_PAIRS and G >= 4 and T >= 128 else 1
    gsub_max, cols = -(-G // rg), -(-T // rt)  # threads needed along G, T
    needed = gsub_max * cols
    block = 256 if needed >= _SMS * 256 else (
        128 if needed >= _SMS * 128 else 64)
    if cols >= 32:
        gsub = max(1, min(block // 32, gsub_max))
        tl = max(32, block // gsub // 32 * 32)
        tl = min(tl, -(-cols // 32) * 32)
    else:
        tl = cols
        gsub = max(1, min(block // cols, gsub_max))
    tt, tg = tl * rt, gsub * rg
    kc = K if K > 0 else 1
    while kc > 1 and _compat_smem(tt, tg, kc, K, W) > _SMEM_BUDGET:
        kc -= 1
    smem = _compat_smem(tt, tg, kc, K, W)
    if smem > _MAX_SMEM:
        raise ValueError(f"compat: one key of W={W} words does not fit the "
                         "kernel's shared-memory tile")
    grid = (-(-T // tt), -(-G // tg))
    threads = 256 if grid[0] * grid[1] < _SMS else tl * gsub
    return CompatTile(tt, tg, rg, rt, kc, threads, grid, smem)


def compat_reference(g_mask, g_has, g_tol, t_mask, t_has, t_tol):
    """Plain PyTorch version of ``compat``: the JAX package's jnp compat
    loop (karpenter_tpu/ops/kernels.py feasibility), key by key so no
    [G,T,K,W] intermediate is built."""
    G, K, _ = g_mask.shape
    T = t_mask.shape[0]
    out = torch.ones((G, T), dtype=torch.bool, device=g_mask.device)
    for k in range(K):
        ov = ((g_mask[:, None, k, :] & t_mask[None, :, k, :]) != 0).any(-1)
        ov = ov | (g_tol[:, None, k] & t_tol[None, :, k])
        both = g_has[:, None, k] & t_has[None, :, k]
        out = out & (~both | ov)
    return out


def compat(g_mask, g_has, g_tol, t_mask, t_has, t_tol):
    """compat [G,T] bool. g_mask [G,K,W] / t_mask [T,K,W] int32 bit
    patterns; g_has/g_tol [G,K] and t_has/t_tol [T,K] bool. CPU tensors
    take ``compat_reference``; CUDA tensors launch ``csrc/compat.cu``.
    The checks below are written for speed: pack calls this once per
    group row."""
    tensors = (g_mask, g_has, g_tol, t_mask, t_has, t_tol)
    if (g_mask.is_cpu and g_has.is_cpu and g_tol.is_cpu and t_mask.is_cpu
            and t_has.is_cpu and t_tol.is_cpu):
        return compat_reference(*tensors)
    index = g_mask.get_device()
    if not (g_mask.is_cuda and g_has.get_device() == g_tol.get_device()
            == t_mask.get_device() == t_has.get_device()
            == t_tol.get_device() == index):
        raise ValueError("compat: all inputs must lie on one CUDA device "
                         f"(got {[str(x.device) for x in tensors]})")
    if g_mask.dtype != torch.int32 or t_mask.dtype != torch.int32:
        raise TypeError("compat: masks must be int32 bit patterns")
    if not (g_has.dtype == g_tol.dtype == t_has.dtype == t_tol.dtype
            == torch.bool):
        raise TypeError("compat: has/tol must be bool")
    G, K, W = g_mask.shape
    T = t_mask.shape[0]
    if ((t_mask.shape, g_has.shape, g_tol.shape, t_has.shape, t_tol.shape)
            != ((T, K, W), (G, K), (G, K), (T, K), (T, K))):
        raise ValueError("compat: shape mismatch "
                         f"{[tuple(x.shape) for x in tensors]}")
    if not (g_mask.is_contiguous() and g_has.is_contiguous()
            and g_tol.is_contiguous() and t_mask.is_contiguous()
            and t_has.is_contiguous() and t_tol.is_contiguous()):
        raise ValueError("compat: inputs must be contiguous")
    out = torch.empty((G, T), dtype=torch.bool, device=g_mask.device)
    if G == 0 or T == 0:
        return out
    tile = compat_tile(G, T, K, W)
    lib = _LIBS.get("compat") or _lib("compat")
    rc = lib.karpenter_compat(_COMPAT_ARGS.pack(
        g_mask.data_ptr(), g_has.data_ptr(), g_tol.data_ptr(),
        t_mask.data_ptr(), t_has.data_ptr(), t_tol.data_ptr(),
        out.data_ptr(), G, T, K, W, tile.tt, tile.tg, tile.rg, tile.rt,
        tile.kc, tile.threads, tile.smem, index, _stream(index)))
    _check_launch(lib, rc, "compat")
    LAUNCHES["compat"] += 1
    return out


def compat_noop(device) -> None:
    """Launch the empty kernel of ``csrc/compat.cu`` on ``device``'s current
    stream: the least device time any launch takes. Not counted in
    ``LAUNCHES``."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    lib = _lib("compat")
    with torch.cuda.device(index):
        _check_launch(lib, lib.karpenter_compat_noop(_stream(index)), "noop")
