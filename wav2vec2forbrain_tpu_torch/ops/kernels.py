"""Build, load and launch-count the hand-written CUDA kernels (csrc/*.cu).

All sources are compiled by ``nvcc`` for ``sm_90a`` (one nvcc process per
source, all started together) and linked into ONE shared library with a
plain C interface, loaded with ctypes. The build runs at first use,
into ``build/kernels/<hash>/`` at the repository root (git-ignored), keyed
by a hash of the sources and flags, so a fresh checkout builds everything by
itself and an unchanged tree reuses its build. Nothing is built from
outside the repository.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; `check` raises on a nonzero code.

`LAUNCHES` counts, per kernel, the calls of each wrapper that launched its
kernel (the wrappers add one right where they launch, nowhere else), so a run
can show that its main path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "kernels"
LIB_NAME = "libw2vb_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

LAUNCHES = {
    "preproc": 0, "gru": 0, "attention": 0, "conv_glu": 0,
    "preproc_bwd": 0, "gru_bwd": 0, "attention_bwd": 0, "conv_glu_bwd": 0,
    # the GRU recurrence through its per-direction entry (ops/gru.py::gru_recurrence_dir)
    "gru_dir": 0, "gru_dir_bwd": 0,
    "layernorm": 0, "layernorm_bwd": 0,
}

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# C signatures (csrc/*.cu, extern "C"): pointers and the stream as void*
_SIGNATURES = {
    # x, w, bias, day_idxs, taps, z, out, B, T, C, n_taps, n_days, k, stride, t_out, stream
    "w2vb_preproc_fwd": [_vp] * 7 + [_i] * 8 + [_vp],
    # x, w, w_t, bias, day_idxs, taps, g, dz, dy, dx, dw, db,
    # B, T, C, n_taps, n_days, k, stride, t_out, stream
    "w2vb_preproc_bwd": [_vp] * 12 + [_i] * 8 + [_vp],
    # gi, w_hh, w_bf16, b_hh, h0, ys, T, ND, B, H, cluster size, stream
    "w2vb_gru_fwd_cluster": [_vp, _vp, _i, _vp, _vp, _vp] + [_i] * 5 + [_vp],
    # H, w_bf16 -> the fused forward's cluster size (0: none fits)
    "w2vb_gru_fwd_cluster_size": [_i] * 2,
    # gi, w, w_bf16, b_hh, h0, ys, g, hpc, hpct, dghc, dghct, dbp, dhz, gh, dgi, dgh, dw, db, dh0,
    # T, ND, B, H, Bp, Hp, Rp, stream
    "w2vb_gru_bwd": [_vp, _vp, _i] + [_vp] * 16 + [_i] * 7 + [_vp],
    # gi, wt, w_bf16, b_hh, h0, hc, ys, T, ND, B, H, Bp, Hp, stream
    "w2vb_gru_dir_fwd": [_vp, _vp, _i, _vp, _vp, _vp, _vp] + [_i] * 6 + [_vp],
    # q, k, v, o, io_bf16, cd_bf16, simt, B, T, NH, D, scale, seed, keep_prob, inv_keep, stream
    "w2vb_attention_fwd": [_vp] * 4 + [_i] * 7 + [_f, _i, _f, _f, _vp],
    # q, k, v, g, dq, dk, dv, stats, io_bf16, cd_bf16, B, T, NH, D, scale, seed, keep_prob,
    # inv_keep, stream
    "w2vb_attention_bwd": [_vp] * 8 + [_i] * 6 + [_f, _i, _f, _f, _vp],
    # y, w, z, io_bf16, cd_bf16, B, T, C, ks, stream
    "w2vb_conv_glu_fwd": [_vp] * 3 + [_i] * 6 + [_vp],
    # y, w, dz, dy, dk, io_bf16, cd_bf16, B, T, C, ks, stream
    "w2vb_conv_glu_bwd": [_vp] * 5 + [_i] * 6 + [_vp],
    # x, scale, bias, y, io_bf16, rows, C, eps, stream
    "w2vb_layernorm_fwd": [_vp] * 4 + [_i] * 3 + [_f, _vp],
    # x, scale, dy, dx, dgp, dbp, io_bf16, B, T, C, chunks, eps, stream
    "w2vb_layernorm_bwd": [_vp] * 6 + [_i] * 5 + [_f, _vp],
    # io_bf16, B, T, C -> the backward's T chunks per batch element
    "w2vb_layernorm_bwd_chunks": [_i] * 4,
}

_lib = None
_lock = threading.Lock()
build_info = {}  # filled by build(): path, seconds, cached, log


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of wav2vec2forbrain_tpu_torch cannot be built on this machine"
    )


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/kernels/<hash>/ unless already built.

    verbose adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel); the compiler's output lands in build_info["log"] and in
    build.log beside the library."""
    out = BUILD_ROOT / source_hash() / LIB_NAME
    start = time.perf_counter()
    if out.exists():
        if build_info.get("path") != str(out):  # keep the record of a build made here
            log_path = out.parent / "build.log"
            build_info.update(
                path=str(out), seconds=0.0, cached=True,
                log=log_path.read_text() if log_path.exists() else "",
            )
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    compile_flags = [*NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = ""
    failed = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        log += text
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.parent / f"{LIB_NAME}.{tag}"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    (out.parent / "build.log").write_text(log)
    os.replace(tmp, out)
    build_info.update(
        path=str(out), seconds=time.perf_counter() - start, cached=False, log=log
    )
    return out


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use; see build)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build(verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.w2vb_error_string.argtypes = [ctypes.c_int]
            handle.w2vb_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(name: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        msg = lib().w2vb_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    """PyTorch's current stream on t's device, as the int ctypes passes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Every tensor a kernel touches must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all operands must be CUDA tensors on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
