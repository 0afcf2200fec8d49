"""Hand-written CUDA kernels of the port, their builds and their wrappers.

The counterpart of ``karpenter_tpu/ops/pallas_kernels.py``. Each kernel
sits beside its plain PyTorch version:

- ``compat`` — requirement compatibility ``[G,T]`` of group rows against
  type (or template) rows over K keys of W mask words
  (``csrc/compat.cu``, replacing ``compat_pallas``, which only took W=1).
  ``compat_reference`` is its plain version.

A wrapper given CPU tensors runs the plain version — that is the port's
CPU path and what the tests run. Given CUDA tensors it launches the kernel
or raises; it never falls back to the plain version.

Kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers), loaded with
``ctypes``. Builds land in ``build/torch_kernels/`` at the repository root,
named by a hash of the source and flags, so an edited source rebuilds.
``LAUNCHES`` counts each kernel launch (only launches, not plain-version
calls), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
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
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "compat":
            lib.karpenter_compat.argtypes = [vp] * 7 + [ci] * 4 + [vp]
            lib.karpenter_compat.restype = ci
            lib.karpenter_compat_smem_bytes.argtypes = [ci, ci]
            lib.karpenter_compat_smem_bytes.restype = ctypes.c_size_t
        lib.karpenter_cuda_error_string.argtypes = [ci]
        lib.karpenter_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.karpenter_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


# largest dynamic shared memory one block may take on an H100
_MAX_SMEM = 232448


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
    take ``compat_reference``; CUDA tensors launch ``csrc/compat.cu``."""
    tensors = (g_mask, g_has, g_tol, t_mask, t_has, t_tol)
    if all(x.device.type == "cpu" for x in tensors):
        return compat_reference(*tensors)
    dev = g_mask.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("compat: all inputs must lie on one CUDA device "
                         f"(got {[str(x.device) for x in tensors]})")
    if g_mask.dtype != torch.int32 or t_mask.dtype != torch.int32:
        raise TypeError("compat: masks must be int32 bit patterns")
    if any(x.dtype != torch.bool for x in (g_has, g_tol, t_has, t_tol)):
        raise TypeError("compat: has/tol must be bool")
    G, K, W = g_mask.shape
    T = t_mask.shape[0]
    if (t_mask.shape != (T, K, W) or g_has.shape != (G, K)
            or g_tol.shape != (G, K) or t_has.shape != (T, K)
            or t_tol.shape != (T, K)):
        raise ValueError("compat: shape mismatch "
                         f"{[tuple(x.shape) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("compat: inputs must be contiguous")
    lib = _lib("compat")
    if lib.karpenter_compat_smem_bytes(K, W) > _MAX_SMEM:
        raise ValueError(f"compat: K={K} keys of W={W} words exceed the "
                         "kernel's shared-memory tile")
    out = torch.empty((G, T), dtype=torch.bool, device=dev)
    if G == 0 or T == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.karpenter_compat(
            g_mask.data_ptr(), g_has.data_ptr(), g_tol.data_ptr(),
            t_mask.data_ptr(), t_has.data_ptr(), t_tol.data_ptr(),
            out.data_ptr(), G, T, K, W, stream)
    _check_launch(lib, rc, "compat")
    LAUNCHES["compat"] += 1
    return out
