"""Hand-written Hopper kernels: build at first use, bind with ctypes.

Each kernel is CUDA C++ in `stitching_tpu_torch/csrc/` with a plain C
interface; one source may hold several C entries. `load(entry)` compiles
the entry's source `csrc/<name>.cu` with nvcc for sm_90a into
`build/stitching_tpu_torch/` at the repository root (a cache keyed by a hash
of the source, the headers beside it and the flags), loads it with ctypes
and returns the C entry with the argument types of `ENTRIES` set. Nothing
compiles at import time: the CPU tests import every module, and there a
wrapper runs its kernel's plain PyTorch version because the tensor it was
given lies on the CPU. A CUDA tensor launches the kernel or raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "stitching_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the 2-NN entries: three inputs and the scratch, its size, three outputs,
# the sizes and the launch plan (rows a block, segments, targets a segment)
_PAIRS = [_P] * 4 + [_L] + [_P] * 3 + [_I] * 8 + [_P]
_ROWS = [_P] * 4 + [_L] + [_P] * 3 + [_I] * 7 + [_P]
# C entry -> (source, argument types); every entry takes the stream last and
# returns a cudaError_t (but `capture_end`)
ENTRIES = {
    "two_nn_pairs_binary": ("two_nn", _PAIRS),
    "two_nn_binary": ("two_nn", _ROWS),
    # measurement aids: one phase of a binary pairs call (pre-pass, search,
    # search without the fold, merge), in the kernel's design and in the
    # one it replaced (32-bit keys)
    "two_nn_pairs_binary_phase": ("two_nn", [_I] + _PAIRS),
    "two_nn_pairs_binary_key32_phase": ("two_nn_key32", [_I] + _PAIRS),
    "two_nn_pairs_float": ("two_nn_float", _PAIRS),
    "two_nn_float": ("two_nn_float", _ROWS),
    "bilinear_sample": ("bilinear_sample", [_P] * 4 + [_I] * 6 + [_P]),
    "count_components": ("components", [_P] * 3 + [_I] * 2 + [_P]),
    # one view's MEDIUM and LOW slots: the source, its width and channels,
    # then each output's slot, table, padded and true sizes
    "downscale_view": ("downscale", [_P, _I, _I] + [_P] * 2 + [_I] * 4
                       + [_P] * 2 + [_I] * 5 + [_P]),
    # a graph-cut level: the three grids, scratch, cut and iterations, then
    # pairs, h, w, max_iters, relabel_every and the cluster's CTAs
    "push_relabel": ("push_relabel", [_P] * 6 + [_I] * 6 + [_P]),
    # a panorama band landed in its place in pinned host memory: the
    # destination and its pitch, the band and its pitch, the row's bytes
    # and the rows
    "copy_band_2d": ("band_copy", [_P, _L, _P, _L, _L, _L, _P]),
    # measurement aids: empty launches, the floor under every kernel's time;
    # and a stream capture that counts what one call launches (`capture_end`
    # returns the count, or minus a cudaError_t)
    "launch_floor": ("launch_floor", [_I, _P]),
    "capture_begin": ("launch_floor", [_P]),
    "capture_end": ("launch_floor", [_P]),
}
KERNELS = tuple(dict.fromkeys(src for src, _ in ENTRIES.values()))

_libs = {}       # source -> loaded library
_entries = {}    # C entry -> ctypes function
_lock = threading.Lock()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name):
    """Where the built library of kernel `name` lives: content-addressed by
    its source, every header under `csrc/` (an edit to a shared header
    rebuilds) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC)
                     if f.endswith((".cuh", ".h", ".hpp")))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as fh:
            digest.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _compile_cmd(name, out):
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, name + ".cu")]


def build(names=KERNELS):
    """Compile every kernel in `names` that is not built yet, one nvcc
    process per source, all started together. Returns the library paths."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs.append((name, path, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(entry):
    """The C entry `entry` (a ctypes function); its source is built on
    first use."""
    fn = _entries.get(entry)
    if fn is not None:
        return fn
    with _lock:
        fn = _entries.get(entry)
        if fn is None:
            name, argtypes = ENTRIES[entry]
            lib = _libs.get(name)
            if lib is None:
                path = library_path(name)
                if not os.path.exists(path):
                    build((name,))
                lib = _libs[name] = ctypes.CDLL(path)
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[entry] = fn
        return fn


def check(status, what):
    """Raise if a C entry returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def stream_ptr(device):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
