"""The native (C++) solve engine of the port, built at first use, via ctypes.

The port's copy of ``karpenter_tpu/native``: ``kernel.cpp`` is that
package's source unchanged — host code, the grouped feasibility + pack of
``ops.kernels.solve_step`` over the same tensorized snapshot layout, not a
device kernel. ``load()`` compiles it with ``g++ -O2 -shared -fPIC
-std=c++17`` into ``build/torch_kernels/`` at the repository root (or
``$KARPENTER_NATIVE_CACHE``), named by a hash of the source and the flags
so an edited source rebuilds, and returns the bound entry point; it
returns None when no toolchain is available. The port never loads the JAX
package's library.

``solve_step`` takes the numpy ``kernel_args`` dict and returns numpy
``assign``/``assign_e``/``used``/``tmpl``/``F``, bit-equal to
``ops.kernels.solve_step`` on the same arguments; ``solve_probe_batch``
packs N counterfactual rows over one shared snapshot and returns the
probe's reductions (``placed_g``, ``used``), as ``ops.kernels.probe_step``
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from karpenter_tpu_torch.ops.tensorize import UNCAPPED
from karpenter_tpu_torch.utils.envknobs import env_str

SRC = Path(__file__).resolve().parent / "kernel.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_load_failed = False

_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def lib_path() -> Path:
    """Where the library of this source and these flags lives."""
    tag = hashlib.sha1(SRC.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    cache = env_str("KARPENTER_NATIVE_CACHE") or str(BUILD_DIR)
    return Path(cache) / f"libkarpenter_native-{tag}.so"


def _build(so: Path) -> bool:
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


# shared (non-output) argtype blocks; the solve and probe-batch entries
# differ only in the leading N, the g_count/e_avail axes, and the outputs
_MID_ARGTYPES = (
    [_u32p, _u8p, _u8p, _f32p, _i32p, _u8p, _u8p, _u8p, _i32p,
     _u8p, _u32p, _u32p]                                # group side
    + [ctypes.c_int, _i32p, _u8p]                       # spread classes
    + [ctypes.c_int, _u8p, _u8p]                        # affinity classes
    + [ctypes.c_int, _f32p, _u8p, _i32p, _i32p, _u32p, _u32p, _i32p]  # existing
    + [_u32p, _u8p, _u8p, _f32p, _f32p, _i32p]          # type side
    + [_i32p, _i32p, _u8p]                              # offerings
    + [_u32p, _u8p, _u8p, _f32p, _f32p, _i32p]          # templates
)


def load():
    """Bound ``karpenter_solve()``, or None if the engine is unusable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib.karpenter_solve
    if _load_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib.karpenter_solve
        so = lib_path()
        if not so.exists() and not _build(so):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _load_failed = True
            return None
        fn = lib.karpenter_solve
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] * 11
            + _MID_ARGTYPES
            + [_i32p, _i32p, _u8p, _i32p, _u8p]                   # outputs
        )
        bfn = lib.karpenter_solve_probe_batch
        bfn.restype = ctypes.c_int
        bfn.argtypes = (
            [ctypes.c_int] * 12   # N + the 11 dims
            + _MID_ARGTYPES
            + [_i32p, _i32p]      # placed_g [N*G], used [N]
        )
        _lib = lib
        return fn


def load_probe_batch():
    """Bound ``karpenter_solve_probe_batch()``, or None when the library is
    unavailable."""
    if load() is None:
        return None
    return _lib.karpenter_solve_probe_batch


def available() -> bool:
    return load() is not None


def _prep(args: dict, max_bins: int, g_count, e_avail):
    """Shared argument marshalling for the solve and probe-batch entries:
    (dims, mid) where dims = [G,T,K,W,R,M,O,B,Vz,Vc,CW] and mid is the
    ctypes argument block between the dims and the outputs. ``g_count`` and
    ``e_avail`` are passed explicitly — the batch entry feeds [N,...] rows
    through the same positions."""
    g_mask = np.ascontiguousarray(args["g_mask"], dtype=np.uint32)
    G, K, W = g_mask.shape
    t_mask = np.ascontiguousarray(args["t_mask"], dtype=np.uint32)
    T = t_mask.shape[0]
    m_mask = np.ascontiguousarray(args["m_mask"], dtype=np.uint32)
    M = m_mask.shape[0]
    off_zone = np.ascontiguousarray(args["off_zone"], dtype=np.int32)
    O = off_zone.shape[1]
    g_demand = np.ascontiguousarray(args["g_demand"], dtype=np.float32)
    R = g_demand.shape[1]
    gza = np.ascontiguousarray(args["g_zone_allowed"], dtype=np.uint8)
    gca = np.ascontiguousarray(args["g_ct_allowed"], dtype=np.uint8)
    # width-paired arrays default from their partner so a caller supplying
    # only one cannot feed the kernel mismatched class axes
    CW = np.asarray(
        args.get("g_decl", args.get("g_match", np.zeros((G, 1))))
    ).shape[1]
    g_decl = np.ascontiguousarray(
        args.get("g_decl", np.zeros((G, CW), dtype=np.uint32)), dtype=np.uint32
    )
    g_match = np.ascontiguousarray(
        args.get("g_match", np.zeros((G, CW), dtype=np.uint32)), dtype=np.uint32
    )
    if g_match.shape != g_decl.shape:
        raise ValueError(f"g_decl/g_match shape mismatch: {g_decl.shape} vs {g_match.shape}")
    C = np.asarray(args.get("g_sown", args.get("g_smatch", np.zeros((G, 1))))).shape[1]
    g_sown = np.ascontiguousarray(
        args.get("g_sown", np.full((G, C), UNCAPPED, dtype=np.int32)), dtype=np.int32
    )
    g_smatch = np.ascontiguousarray(
        args.get("g_smatch", np.zeros((G, C), dtype=np.uint8)), dtype=np.uint8
    )
    if g_smatch.shape != g_sown.shape:
        raise ValueError(f"g_sown/g_smatch shape mismatch: {g_sown.shape} vs {g_smatch.shape}")
    A = np.asarray(args.get("g_aneed", args.get("g_amatch", np.zeros((G, 1))))).shape[1]
    g_aneed = np.ascontiguousarray(
        args.get("g_aneed", np.zeros((G, A), dtype=np.uint8)), dtype=np.uint8
    )
    g_amatch = np.ascontiguousarray(
        args.get("g_amatch", np.zeros((G, A), dtype=np.uint8)), dtype=np.uint8
    )
    if g_amatch.shape != g_aneed.shape:
        raise ValueError(f"g_aneed/g_amatch shape mismatch: {g_aneed.shape} vs {g_amatch.shape}")
    B = int(max_bins)
    # existing-node tensors (default: one inert zero-capacity node); the
    # probe batch passes [N,E,R] rows, so E comes from the TRAILING axes
    e_avail = np.ascontiguousarray(e_avail, dtype=np.float32)
    E = e_avail.shape[-2]
    ge_ok = np.ascontiguousarray(
        args.get("ge_ok", np.zeros((G, E), dtype=np.uint8)), dtype=np.uint8
    )
    e_npods = np.ascontiguousarray(
        args.get("e_npods", np.zeros(E, dtype=np.int32)), dtype=np.int32
    )
    e_scnt = np.ascontiguousarray(
        args.get("e_scnt", np.zeros((E, C), dtype=np.int32)), dtype=np.int32
    )
    e_decl = np.ascontiguousarray(
        args.get("e_decl", np.zeros((E, CW), dtype=np.uint32)), dtype=np.uint32
    )
    e_match = np.ascontiguousarray(
        args.get("e_match", np.zeros((E, CW), dtype=np.uint32)), dtype=np.uint32
    )
    e_aff = np.ascontiguousarray(
        args.get("e_aff", np.zeros((E, A), dtype=np.int32)), dtype=np.int32
    )
    if e_aff.shape != (E, A):
        raise ValueError(f"e_aff shape mismatch: {e_aff.shape} vs {(E, A)}")

    dims = [G, T, K, W, R, M, O, B, gza.shape[1], gca.shape[1], CW]
    mid = [
        g_mask,
        np.ascontiguousarray(args["g_has"], dtype=np.uint8),
        np.ascontiguousarray(
            args.get("g_tol", np.zeros((G, K), dtype=np.uint8)), dtype=np.uint8
        ),
        g_demand,
        np.ascontiguousarray(g_count, dtype=np.int32),
        gza, gca,
        np.ascontiguousarray(args["g_tmpl_ok"], dtype=np.uint8),
        np.ascontiguousarray(
            args.get("g_bin_cap", np.full(G, 1 << 30, dtype=np.int32)), dtype=np.int32
        ),
        np.ascontiguousarray(
            args.get("g_single", np.zeros(G, dtype=np.uint8)), dtype=np.uint8
        ),
        g_decl, g_match,
        C, g_sown, g_smatch,
        A, g_aneed, g_amatch,
        E, e_avail, ge_ok, e_npods, e_scnt, e_decl, e_match, e_aff,
        t_mask,
        np.ascontiguousarray(args["t_has"], dtype=np.uint8),
        np.ascontiguousarray(
            args.get("t_tol", np.zeros((T, K), dtype=np.uint8)), dtype=np.uint8
        ),
        np.ascontiguousarray(args["t_alloc"], dtype=np.float32),
        np.ascontiguousarray(args["t_cap"], dtype=np.float32),
        np.ascontiguousarray(args["t_tmpl"], dtype=np.int32),
        off_zone,
        np.ascontiguousarray(args["off_ct"], dtype=np.int32),
        np.ascontiguousarray(args["off_avail"], dtype=np.uint8),
        m_mask,
        np.ascontiguousarray(args["m_has"], dtype=np.uint8),
        np.ascontiguousarray(
            args.get("m_tol", np.zeros((M, K), dtype=np.uint8)), dtype=np.uint8
        ),
        np.ascontiguousarray(args["m_overhead"], dtype=np.float32),
        np.ascontiguousarray(args["m_limits"], dtype=np.float32),
        np.ascontiguousarray(
            args.get("m_minv", np.zeros(M, dtype=np.int32)), dtype=np.int32
        ),
    ]
    return dims, mid


def solve_step(args: dict, max_bins: int) -> dict:
    """``ops.kernels.solve_step`` on the host: the same numpy
    ``kernel_args`` dict in, the same output dict (assign/assign_e/used/
    tmpl/F) out, numpy throughout."""
    fn = load()
    if fn is None:
        raise RuntimeError("native engine unavailable (no g++?)")
    R = np.asarray(args["g_demand"]).shape[1]
    e_avail = args.get("e_avail")
    if e_avail is None:
        e_avail = np.zeros((1, R), dtype=np.float32)
    dims, mid = _prep(args, max_bins, args["g_count"], e_avail)
    G, T, B = dims[0], dims[1], dims[7]
    E = np.asarray(e_avail).shape[0]

    assign = np.zeros((G, B), dtype=np.int32)
    assign_e = np.zeros((G, E), dtype=np.int32)
    used = np.zeros(B, dtype=np.uint8)
    tmpl = np.zeros(B, dtype=np.int32)
    F = np.zeros((G, T), dtype=np.uint8)

    rc = fn(*dims, *mid, assign, assign_e, used, tmpl, F)
    if rc != 0:
        raise RuntimeError(f"native engine failed: rc={rc}")
    return {
        "assign": assign,
        "assign_e": assign_e,
        "used": used.astype(bool),
        "tmpl": tmpl,
        "F": F.astype(bool),
    }


def solve_probe_batch(args: dict, g_count_rows, e_avail_rows, max_bins: int):
    """The batched consolidation probe: N counterfactual rows over ONE
    shared snapshot in a single native call. ``args`` is the kernel_args
    dict WITHOUT g_count/e_avail (``kernel_args(..., include_counts=
    False)``); ``g_count_rows`` is [N, G] i32, ``e_avail_rows`` [N, E, R]
    f32. The engine builds feasibility once and packs per row, returning
    the probe's reductions (placed_g [N, G], used [N])."""
    fn = load_probe_batch()
    if fn is None:
        raise RuntimeError("native engine unavailable (no g++?)")
    g_count_rows = np.ascontiguousarray(g_count_rows, dtype=np.int32)
    e_avail_rows = np.ascontiguousarray(e_avail_rows, dtype=np.float32)
    N, G = g_count_rows.shape
    if e_avail_rows.shape[0] != N:
        raise ValueError(
            f"row-count mismatch: g_count {N} vs e_avail {e_avail_rows.shape[0]}")
    dims, mid = _prep(args, max_bins, g_count_rows, e_avail_rows)
    if dims[0] != G:
        raise ValueError(f"g_count_rows axis {G} != snapshot G {dims[0]}")

    placed_g = np.zeros((N, G), dtype=np.int32)
    used = np.zeros(N, dtype=np.int32)
    rc = fn(N, *dims, *mid, placed_g, used)
    if rc != 0:
        raise RuntimeError(f"native probe batch failed: rc={rc}")
    return placed_g, used
