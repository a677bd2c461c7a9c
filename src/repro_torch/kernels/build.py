"""Builds the port's CUDA kernels and binds them with ctypes (no JAX
counterpart: Pallas kernels are compiled by XLA).

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface, at first use, into `build/repro_torch/<hash>/`
at the repository root (git-ignored). The hash covers every source and
header in `csrc/` and the flags, so an edited source rebuilds and an
unchanged one is reused. `build_all()` starts one `nvcc` per source at the
same time and waits for all of them.

Flags: `sm_90a` (Hopper), C++17, -O3, and deliberately no
`--use_fast_math`: the kernels' expf/tanhf/sqrtf keep full precision for
the float32 parity bound.

`SimgnnParams` mirrors the C struct of `csrc/simgnn_common.cuh`;
`simgnn_params` fills it from a params tree once and reuses it while the
tree's tensors are the same objects, unmodified (the caller keeps the
returned tensors alive until the launch is enqueued). A library's layout
checks and a C function's ctypes signature are likewise set once per
process (`library`, `bind`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: the libraries that take the `SimgnnParams` struct
SIMGNN_SOURCES = ("sparse_pair", "packed_pair", "fused_pair", "fused_gcn",
                  "simgnn_head", "retrieval")
SOURCES = SIMGNN_SOURCES + ("moe_experts", "flash_attn", "wkv6",
                            "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_GCN = 8          # SIMGNN_MAX_GCN
MAX_FCN = 8          # SIMGNN_MAX_FCN
MAX_HEAD = 64        # SIMGNN_MAX_HEAD

_LIBS: dict[str, ctypes.CDLL] = {}
#: params structs by (device, identity and version of every leaf); each
#: entry holds the leaves themselves, so no key's ids can be reused.
_PARAMS: dict[tuple, tuple] = {}
_PARAMS_KEPT = 16
#: seconds the last `build_all` spent compiling (0.0 when every library
#: was already built).
last_build_seconds = 0.0


class SimgnnParams(ctypes.Structure):
    _fields_ = [("gcn_w", ctypes.c_void_p * MAX_GCN),
                ("gcn_b", ctypes.c_void_p * MAX_GCN),
                ("fcn_w", ctypes.c_void_p * MAX_FCN),
                ("fcn_b", ctypes.c_void_p * MAX_FCN),
                ("att_w", ctypes.c_void_p), ("ntn_w", ctypes.c_void_p),
                ("ntn_v", ctypes.c_void_p), ("ntn_b", ctypes.c_void_p),
                ("gcn_dims", ctypes.c_int * (MAX_GCN + 1)),
                ("fcn_dims", ctypes.c_int * (MAX_FCN + 1)),
                ("n_gcn", ctypes.c_int), ("n_fcn", ctypes.c_int),
                ("ntn_k", ctypes.c_int), ("f_max", ctypes.c_int)]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every missing library in parallel; returns the build dir.
    Each library's ptxas report (registers, shared memory, spills) is kept
    beside it as `<name>.log`."""
    global last_build_seconds
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f"{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out / f"{name}.so")
        else:
            failed.append(name)
    last_build_seconds = time.perf_counter() - t0
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"{name}.so"))
        if name in SIMGNN_SOURCES:
            lib.simgnn_params_size.restype = ctypes.c_int
            if lib.simgnn_params_size() != ctypes.sizeof(SimgnnParams):
                raise RuntimeError(f"{name}: SimgnnParams layout differs from "
                                   "the ctypes mirror")
        _LIBS[name] = lib
    return lib


def check_side_struct(lib: ctypes.CDLL, fn_name: str, struct) -> None:
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    if fn() != ctypes.sizeof(struct):
        raise RuntimeError(f"{struct.__name__} layout differs from the C side")


def bind(fn, argtypes: list, restype=ctypes.c_int):
    """`fn` (a ctypes function of a loaded library) with its signature
    set; the kernel modules bind each entry point once."""
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def check_launch(err: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")


def checked(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> int:
    """Data pointer of `t` after checking what a kernel takes: a CUDA
    tensor of `dtype` and `shape`, contiguous."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous CUDA {dtype} "
                         f"tensor of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    return t.data_ptr()


def _f32(t: torch.Tensor) -> torch.Tensor:
    # bf16 (or any float) weights are upcast to float32 before launch: the
    # Pallas bodies upcast them in the kernel, and they are a few KB.
    return t.float().contiguous()


def simgnn_params(params, device) -> tuple[SimgnnParams, list]:
    """(C struct, tensors to keep alive) for a SimGNN params tree, built
    on the first call and reused while the leaves are the same tensors,
    unmodified. Raises on configs beyond what the kernels take.

    The tree may hold only the parts a kernel reads: `gcn` + `att` (the
    embedding kernel), `ntn` + `fcn` (the head) or `fcn` alone (the NTN
    top-M scan). Absent parts stay null with zero layers; without `gcn`,
    `gcn_dims[0]` carries the embedding width F read off the NTN."""
    gcn, fcn = params.get("gcn", []), params.get("fcn", [])
    att, ntn = params.get("att"), params.get("ntn")
    leaves = ([t for p in gcn for t in (p["w"], p["b"])]
              + [t for p in fcn for t in (p["w"], p["b"])]
              + ([att["w"]] if att is not None else [])
              + ([ntn[n] for n in ("w", "v", "b")] if ntn is not None
                 else []))
    key = (str(device), tuple(sorted(params))) + tuple(
        (id(t), t._version) for t in leaves)
    hit = _PARAMS.get(key)
    if hit is not None:
        return hit[0], hit[1]
    if "gcn" in params and not 1 <= len(gcn) <= MAX_GCN or \
            "fcn" in params and not 1 <= len(fcn) <= MAX_FCN:
        raise ValueError(f"kernels take 1..{MAX_GCN} GCN and 1..{MAX_FCN} "
                         f"FCN layers, got {len(gcn)} and {len(fcn)}")
    k = (ntn["b"].shape[0] if ntn is not None
         else fcn[0]["w"].shape[0] if fcn else 0)
    fcn_dims = [k] + [p["w"].shape[1] for p in fcn]
    if fcn and (max(fcn_dims) > MAX_HEAD or fcn_dims[-1] != 1):
        raise ValueError(f"kernels take NTN K and FCN widths <= {MAX_HEAD} "
                         f"ending in 1, got {fcn_dims}")
    keep = []

    def dev(t):
        t = _f32(t.to(device))
        keep.append(t)
        return t.data_ptr()

    s = SimgnnParams()
    for i, p in enumerate(gcn):
        s.gcn_w[i], s.gcn_b[i] = dev(p["w"]), dev(p["b"])
    for i, p in enumerate(fcn):
        s.fcn_w[i], s.fcn_b[i] = dev(p["w"]), dev(p["b"])
    if att is not None:
        s.att_w = dev(att["w"])
    if ntn is not None:
        s.ntn_w, s.ntn_v, s.ntn_b = (dev(ntn[n]) for n in ("w", "v", "b"))
    dims = ([gcn[0]["w"].shape[0]] + [p["w"].shape[1] for p in gcn] if gcn
            else [ntn["w"].shape[-1] if ntn is not None else 0])
    for i, d in enumerate(dims):
        s.gcn_dims[i] = d
    for i, d in enumerate(fcn_dims):
        s.fcn_dims[i] = d
    s.n_gcn, s.n_fcn, s.ntn_k = len(gcn), len(fcn), k
    s.f_max = max(dims[1:], default=0)
    if len(_PARAMS) >= _PARAMS_KEPT:
        _PARAMS.pop(next(iter(_PARAMS)))
    _PARAMS[key] = (s, keep, leaves)
    return s, keep
