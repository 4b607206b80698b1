"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source (in parallel) and links them into one shared
library with a plain C interface for ``sm_90a`` (Hopper), at first use, into ``build/`` beside the
package (listed in ``.gitignore``); the library is loaded with ``ctypes``.
The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded. No PyTorch headers are
compiled, which keeps the build to seconds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("fused_mlp_fwd.cu", "fused_mlp_bwd.cu", "quad_build.cu",
           "quad_fold.cu", "gather_rows.cu", "copy_ladder.cu",
           "blended_encode.cu", "fused_adam.cu", "time_code_bwd.cu")
HEADERS = ("quad_layout.cuh",)  # included by sources; part of the build's hash
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_LL_P = ctypes.POINTER(ctypes.c_longlong)
_F = ctypes.c_float
_SIGNATURES = {
    # x, out, wt, bias, meta, n_rows, stream
    "fused_mlp_fwd": (_VOID_P, _VOID_P, _VOID_P, _VOID_P, _LL_P, _LL, _VOID_P),
    # x, g, dx, wt, bias, wf, wstream, partials, total, meta, n_rows, n_parts,
    # stream
    "fused_mlp_bwd": (_VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
                      _VOID_P, _VOID_P, _VOID_P, _LL_P, _LL, _LL, _VOID_P),
    # table, out, n_rows, row_bytes, meta, stream
    "quad_build": (_VOID_P, _VOID_P, _LL, _LL, _LL_P, _VOID_P),
    # g, out, n_rows, quarter_bytes, elem_bytes, meta, stream
    "quad_fold": (_VOID_P, _VOID_P, _LL, _LL, _LL, _LL_P, _VOID_P),
    # table, idx, out, n_rows, row_bytes, idx_bytes, depth, stream
    "gather_rows": (_VOID_P, _VOID_P, _VOID_P, _LL, _LL, _LL, _LL, _VOID_P),
    # x, out, n_rows, row_bytes, block_rows, stream
    "ladder_copy": (_VOID_P, _VOID_P, _LL, _LL, _LL, _VOID_P),
    "ladder_bcast": (_VOID_P, _VOID_P, _LL, _LL, _LL, _VOID_P),
    # r0..r6, out, n_rows, row_bytes, block_rows, stream
    "ladder_fetch7": (*(_VOID_P,) * 8, _LL, _LL, _LL, _VOID_P),
    # table, entry_idx, wy, fx, fz, code, out, cg, bh, n, L, H, W, FL,
    # elem_bytes, stream
    "blended_encode_fwd": (*(_VOID_P,) * 9, *(_LL,) * 6, _VOID_P),
    # gbar, cg, bh, code, wy, fx, fz, mfac, coder, d_code, d_wy, d_fx, d_fz,
    # n, L, H, W, FL, elem_bytes, stream
    "blended_encode_bwd_sample": (*(_VOID_P,) * 13, *(_LL,) * 6, _VOID_P),
    # skey, perm, mfac, coder, d_table, partial, n, L, H, W, FL, elem_bytes,
    # stream
    "blended_encode_bwd_chunks": (*(_VOID_P,) * 6, *(_LL,) * 6, _VOID_P),
    # skey, partial, d_table, n, L, W, elem_bytes, stream
    "blended_encode_bwd_spans": (*(_VOID_P,) * 3, *(_LL,) * 4, _VOID_P),
    # d_table, bytes, stream
    "blended_encode_zero": (_VOID_P, _LL, _VOID_P),
    # n, L, E, elem_bytes
    "blended_encode_bwd_column_scratch": (_LL, _LL, _LL, _LL),
    # gbar, cg, entry_idx, wy, fx, fz, d_wy, d_fx, d_fz, d_table, scratch, n, L,
    # E, elem_bytes, parts, stream
    "blended_encode_bwd_column": (*(_VOID_P,) * 11, *(_LL,) * 5, _VOID_P),
    # segments, n_segs, c1, c2, b1, b2, 1 - b1, 1 - b2, eps, stream
    "fused_adam": (_VOID_P, _LL, _VOID_P, _VOID_P, *(_F,) * 5, _VOID_P),
    # g, ld, idx, idx_bytes, partials, out, n, t_rows, d, lanes, rows_per_tile,
    # blocks, tiles, per_block, per_group, smem, vec, stream
    "time_code_bwd": (_VOID_P, _LL, _VOID_P, _LL, _VOID_P, _VOID_P, *(_LL,) * 11,
                      _VOID_P),
}
_RESTYPES = {"blended_encode_bwd_column_scratch": ctypes.c_longlong}  # else c_int

_library = None  # the loaded CDLL, once per process


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libnersemble_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> Tuple[bool, str]:
    """Run the commands concurrently; (all succeeded, their log)."""
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{out}"
                  for cmd, proc, out in zip(cmds, procs, outs))
    log += f"# {time.perf_counter() - start:.1f} s\n"
    return all(proc.returncode == 0 for proc in procs), log


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. One nvcc per source, all started together, then one link.
    The compiler's resource report (``-Xptxas -v``) is kept in
    ``build/build.log``."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{Path(name).stem}.{tag}.o" for name in SOURCES]
    ok, log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o",
                         str(obj)] for name, obj in zip(SOURCES, objects)])
    partial = target.with_suffix(f".{os.getpid()}.partial")
    if ok:
        link_ok, link_log = _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                                       str(partial), *map(str, objects)]])
        ok, log = link_ok, log + link_log
    (BUILD_DIR / "build.log").write_text(log)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if not ok:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(partial, target)
    return target


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _library = lib
    return _library


def int64_array(values) -> ctypes.Array:
    """A host int64 array for a kernel's layout argument."""
    return (ctypes.c_longlong * len(values))(*(int(v) for v in values))


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} (cudaError_t)")


def run(entry: str, *args) -> None:
    """Call the library's C entry ``entry`` and raise if it returned a CUDA
    error."""
    check(getattr(library(), entry)(*args), entry)
