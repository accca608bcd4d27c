"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. Nothing includes
PyTorch's headers, so the build takes seconds. It happens at first use, in
``.kernel_build/<hash of the sources and flags>/`` inside the package (a
directory that ``.gitignore`` lists); a finished library is reused.

Each C entry point takes device pointers, sizes and a ``cudaStream_t`` and
returns ``cudaGetLastError()`` after its launch; ``check`` raises on a
non-zero code. Host threads may launch at once (a server's executor and
scheduler threads): the library loads once under a lock, and ``count``
adds a wrapper's launches under one.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

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
    # x, scale, bias, w, out, B, H, W, C, [tile columns, smem bytes,]
    # stream
    "patch_merging_bf16": (P,) * 5 + (I,) * 6 + (P,),
    "patch_merging_f32": (P, P, P, P, P, I, I, I, I, P),
    # q, k_new, v_new, k_cache, v_cache, out, G, T, Dh, pos, stream
    "cache_append_attention_bf16": (P, P, P, P, P, P, I, I, I, I, P),
    "cache_append_attention_f32": (P, P, P, P, P, P, I, I, I, I, P),
    # q, k, v, out, G, T, Dh, pos, stream
    "decode_attention_bf16": (P, P, P, P, I, I, I, I, P),
    "decode_attention_f32": (P, P, P, P, I, I, I, I, P),
    # x_emb, 6 x (weight, bias), ln, self_k, self_v, cross_k, cross_v,
    # x_out, k_new, v_new, L, B, T, D, H, Hkv (the self caches' KV heads:
    # H, or 1 for MQA), F, L_enc, pos, stream
    "fused_decoder_step_bf16": (P,) * 21 + (I,) * 9 + (P,),
    "fused_decoder_step_f32": (P,) * 21 + (I,) * 9 + (P,),
    # the int8 bundle: 6 x (weight, scale, bias) in place of the pairs
    "fused_decoder_step_i8_bf16": (P,) * 27 + (I,) * 9 + (P,),
    "fused_decoder_step_i8_f32": (P,) * 27 + (I,) * 9 + (P,),
    # B11: x_emb, 6 x (weight, bias), ln, self_k, self_v (written at pos),
    # cross_k, cross_v, x_out, L, B, T, D, H, F, L_enc, pos, stream
    "layers_step_in_place_bf16": (P,) * 19 + (I,) * 8 + (P,),
    "layers_step_in_place_f32": (P,) * 19 + (I,) * 8 + (P,),
    # kernel (0 B1/B11, 1 B7, 2 B10, 3 B12), int8, float32 cache, B, T, D,
    # H, Hkv, F, L_enc, V (head columns, 0 for none), out (8 ints)
    "cluster_geometry": (I,) * 11 + (P,),
    # B10: prev, emb, pos_emb, 6 x (weight, bias), ln, self_k, self_v,
    # cross_k, cross_v, w_head, b_head, nxt, logp, [k_new, v_new,]
    # L, B, T, D, H, F, L_enc, V, T_pos, pos, stream; time-major caches
    # written at pos, or batch-major ones read only and the fresh rows out
    "whole_step_time_major_bf16": (P,) * 24 + (I,) * 10 + (P,),
    "whole_step_time_major_f32": (P,) * 24 + (I,) * 10 + (P,),
    "whole_step_rows_bf16": (P,) * 26 + (I,) * 10 + (P,),
    "whole_step_rows_f32": (P,) * 26 + (I,) * 10 + (P,),
    # B12: emb, pos_emb, 6 x (weight, bias), ln, self_k, self_v (scratch),
    # cross_k, cross_v, w_head, b_head, tokens, lp, cnt, L, B, T_out, D, H,
    # F, L_enc, V, T_pos, sos_id, eos_id, pad_id, stream
    "whole_decode_bf16": (P,) * 24 + (I,) * 12 + (P,),
    "whole_decode_f32": (P,) * 24 + (I,) * 12 + (P,),
    # the int8 bundle: 6 x (weight, scale, bias) in place of the pairs
    "whole_decode_i8_bf16": (P,) * 30 + (I,) * 12 + (P,),
    "whole_decode_i8_f32": (P,) * 30 + (I,) * 12 + (P,),
    # prev, pos, emb, pos_emb, 6 x (weight, bias), ln, self_k, self_v,
    # cross_k, cross_v, w_head, b_head, logits, nxt, logp, k_new, v_new,
    # L, R (the caches' rows), R_run (the rows computed), T, D, H, Hkv, F,
    # L_enc, V, T_pos, stream
    "ragged_step_bf16": (P,) * 28 + (I,) * 11 + (P,),
    "ragged_step_f32": (P,) * 28 + (I,) * 11 + (P,),
    # the int8 bundle: 6 x (weight, scale, bias) in place of the pairs
    "ragged_step_i8_bf16": (P,) * 34 + (I,) * 11 + (P,),
    "ragged_step_i8_f32": (P,) * 34 + (I,) * 11 + (P,),
    # B7's ring mode: as above with seg_start, ring_k, ring_v after cross_v
    # and the ring's rows S after T_pos
    "ragged_ring_bf16": (P,) * 31 + (I,) * 12 + (P,),
    "ragged_ring_f32": (P,) * 31 + (I,) * 12 + (P,),
    "ragged_ring_i8_bf16": (P,) * 37 + (I,) * 12 + (P,),
    "ragged_ring_i8_f32": (P,) * 37 + (I,) * 12 + (P,),
    # x, w_q, scale, y, M, K, N, row stride of w_q, stream
    "dequant_matmul_bf16": (P,) * 4 + (I,) * 4 + (P,),
    "dequant_matmul_f32": (P,) * 4 + (I,) * 4 + (P,),
    # k_in, v_in, src, k_out, v_out, L, R, T_in, T_out, t_ext, row bytes,
    # stream (one entry for every type: the kernel copies bytes)
    "beam_cache_gather": (P,) * 5 + (I,) * 6 + (P,),
    # x, norm1 (2), w_qkv, b_qkv, table, w_out, b_out, norm2 (2), fc1 (2),
    # fc2 (2), out, B, H, W, C, heads, hidden, ws, shift_h, shift_w, the
    # plan (bf16: blocks a cluster, n8 tiles a warp, warp rows, heads a qkv
    # product, hidden columns a chunk; float32: heads a qkv group, hidden
    # columns a chunk), smem bytes, stream
    "swin_block_bf16": (P,) * 15 + (I,) * 15 + (P,),
    "swin_block_f32": (P,) * 15 + (I,) * 12 + (P,),
    # C, heads, hidden, ws, the bf16 plan (5 ints), smem bytes, out
    "swin_block_active_clusters": (I,) * 10 + (P,),
    # device admission: the mailbox's bytes, out host and device addresses
    "admission_mailbox_alloc": (ctypes.c_size_t, P, P),
    "admission_mailbox_free": (P,),
    # mail, cap, cursor, max_scan, pool_k, pool_v, cross_k, cross_v, L, S,
    # P, row bytes, prev, pos, active, finished, tokens, T, lp_sum, count,
    # con_stack, depth, con_ptr, con_mode, con_needs, con_sup, occupant,
    # seg, step, sos, pad, stream
    "admission_pull": (P, I, P, I) + (P,) * 4 + (I,) * 4 + (P,) * 5
                      + (I, P, P, P, I) + (P,) * 5 + (I,) * 4 + (P,),
}

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


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
    if _lib is not None:  # every launch after the first: no lock
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def count(wrapper, attr: str = "launches") -> None:
    """Add one launch to ``wrapper``'s count ``attr`` (a read and a write
    that two threads must not interleave)."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device``: the kernels whose
    grid depends on the batch choose their tiles to cover them."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
