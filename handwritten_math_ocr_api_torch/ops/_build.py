"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. Nothing includes
PyTorch's headers, so the build takes seconds. It happens at first use, in
``.kernel_build/<hash of the sources and flags>/`` inside the package (a
directory that ``.gitignore`` lists); a finished library is reused.

Each C entry point takes device pointers, sizes and a ``cudaStream_t`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, ".kernel_build")
LIB_NAME = "libmathocr_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int

# C signature of every entry point: (argtypes), all return int (cudaError_t)
SIGNATURES = {
    # q, k, v, mask, out, G, N, dh, mask_groups, stream
    "window_attention_bf16": (P, P, P, P, P, I, I, I, I, P),
    "window_attention_f32": (P, P, P, P, P, I, I, I, I, P),
    # x, scale, bias, w, out, B, H, W, C, stream
    "patch_merging_bf16": (P, P, P, P, P, I, I, I, I, P),
    "patch_merging_f32": (P, P, P, P, P, I, I, I, I, P),
    # q, k_new, v_new, k_cache, v_cache, out, G, T, Dh, pos, stream
    "cache_append_attention_bf16": (P, P, P, P, P, P, I, I, I, I, P),
    "cache_append_attention_f32": (P, P, P, P, P, P, I, I, I, I, P),
    # q, k, v, out, G, T, Dh, pos, stream
    "decode_attention_bf16": (P, P, P, P, I, I, I, I, P),
    "decode_attention_f32": (P, P, P, P, I, I, I, I, P),
    # x_emb, 6 x (weight, bias), ln, self_k, self_v, cross_k, cross_v,
    # x_out, k_new, v_new, L, B, T, D, H, F, L_enc, pos, stream
    "fused_decoder_step_bf16": (P,) * 21 + (I,) * 8 + (P,),
    "fused_decoder_step_f32": (P,) * 21 + (I,) * 8 + (P,),
    # prev, pos, emb, pos_emb, 6 x (weight, bias), ln, self_k, self_v,
    # cross_k, cross_v, w_head, b_head, logits, nxt, logp, k_new, v_new,
    # L, R, T, D, H, F, L_enc, V, T_pos, stream
    "ragged_step_bf16": (P,) * 28 + (I,) * 9 + (P,),
    "ragged_step_f32": (P,) * 28 + (I,) * 9 + (P,),
    # k_in, v_in, src, k_out, v_out, L, R, T_in, T_out, t_ext, row bytes,
    # stream (one entry for every type: the kernel copies bytes)
    "beam_cache_gather": (P,) * 5 + (I,) * 6 + (P,),
    # x, norm1 (2), w_qkv, b_qkv, table, w_out, b_out, norm2 (2), fc1 (2),
    # fc2 (2), out, B, H, W, C, heads, hidden, ws, shift_h, shift_w, G, hc,
    # smem bytes, stream
    "swin_block_bf16": (P,) * 15 + (I,) * 12 + (P,),
    "swin_block_f32": (P,) * 15 + (I,) * 12 + (P,),
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if no library for these sources exists yet;
    return the library's path."""
    sources = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(sources))
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT)
    try:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for src, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            if verbose:
                print(log, flush=True)
            objs.append(obj)
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, *, dtype=None, shape=None, device=None,
            aligned: bool = False) -> None:
    """Validate a tensor before its pointer goes to a kernel; ``aligned``
    for one that the kernel reads as 16-byte vectors."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
