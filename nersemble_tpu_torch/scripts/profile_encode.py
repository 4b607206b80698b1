"""Where A3-fwd's time goes, stage by stage, without a profiler that reads
the card's counters (ncu does not run on the measurement machines).

    python -m nersemble_tpu_torch.scripts.profile_encode [--samples 73728]

Copies ``csrc/blended_encode.cu`` into a temporary directory, adds clock64
stamps that thread 0 of every block takes at the phase boundaries of each
stage (issuing the next stage's copies, blend phase A, the wait for the
next stage, phase B with the next stage's setup), builds that copy alone
with the package's nvcc flags and runs it on the flagship case of
``scripts/encode_digests.py``. Prints one JSON line: the mean cycles per
stage and block of each phase, the kernel's ms with and without the
stamps (CUDA events), the blocks' stage count, the card and its power
limit. The stamps cost a few percent; their shares, not their sum, are the
finding.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from nersemble_tpu_torch.ops import cuda_lib
from nersemble_tpu_torch.ops import hash_encoding as he
from nersemble_tpu_torch.scripts.encode_digests import flagship_inputs
from nersemble_tpu_torch.utils.timing import cuda_time_ms, nvidia_smi

PHASES = ("issue", "blend_a", "wait", "blend_b")
# (text of csrc/blended_encode.cu, the same text with a stamp added)
STAMPS = [
    ("    for (int it = 0; it < mine; ++it) {\n",
     "    unsigned long long be_t[4] = {0, 0, 0, 0}, be_c = clock64();\n"
     "    for (int it = 0; it < mine; ++it) {\n"),
    ("        const int k = stage_at(it);\n        const int sl",
     "        BE_STAMP(0);\n        const int k = stage_at(it);\n        const int sl"),
    ("        // the next stage's copies have landed\n",
     "        BE_STAMP(1);\n"),
    ("        // B. out per (unit, level, feature)",
     "        BE_STAMP(2);\n        // B. out per (unit, level, feature)"),
    ("        __syncthreads();\n    }\n    be_cp_wait<0>();\n}",
     "        __syncthreads();\n        BE_STAMP(3);\n    }\n"
     "    if (threadIdx.x == 0) {\n"
     "        for (int i = 0; i < 4; ++i) atomicAdd(&be_prof[i], be_t[i]);\n"
     "        atomicAdd(&be_prof[4], (unsigned long long)mine);\n    }\n"
     "    be_cp_wait<0>();\n}"),
]
PROFILE_API = """
#define BE_STAMP(i) { const unsigned long long c = clock64(); be_t[i] += c - be_c; be_c = c; }
__device__ unsigned long long be_prof[5];
extern "C" int be_prof_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, be_prof, sizeof(be_prof));
}
extern "C" int be_prof_reset() {
    const unsigned long long z[5] = {0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(be_prof, z, sizeof(z));
}
"""


def stamped_source() -> str:
    """csrc/blended_encode.cu with the stamps; raises if a boundary moved."""
    src = (cuda_lib.CSRC_DIR / "blended_encode.cu").read_text()
    anchor = "typedef __nv_bfloat16 bf16;\n"
    if anchor not in src:
        raise RuntimeError("profile_encode: blended_encode.cu has no bf16 typedef")
    src = src.replace(anchor, anchor + PROFILE_API, 1)
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"profile_encode: the stamp site {old.strip()!r} "
                               f"is not in blended_encode.cu once")
        src = src.replace(old, new, 1)
    return src


def build(workdir: Path) -> ctypes.CDLL:
    cu, lib_path = workdir / "blended_encode_stamped.cu", workdir / "libstamped.so"
    cu.write_text(stamped_source())
    subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.blended_encode_fwd.argtypes = cuda_lib._SIGNATURES["blended_encode_fwd"]
    lib.be_prof_read.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    for name in ("blended_encode_fwd", "be_prof_read", "be_prof_reset"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def stamped_fwd(lib, args):
    """blended_encode_fwd_cuda's launch, through the stamped library."""
    table, code, wy, fx, fz, entry_idx, L, Fl, _ = args
    n, W = wy.shape[0], table.shape[1] // 4
    H = W // Fl
    out = torch.empty(n, L * Fl, dtype=torch.float32, device=wy.device)
    CG = torch.empty(n, 2, L, 4, Fl, dtype=table.dtype, device=wy.device)
    BH = torch.empty(n, L, H, Fl, dtype=table.dtype, device=wy.device)
    status = lib.blended_encode_fwd(
        table.data_ptr(), entry_idx.data_ptr(), wy.data_ptr(), fx.data_ptr(),
        fz.data_ptr(), code.data_ptr(), out.data_ptr(), CG.data_ptr(), BH.data_ptr(),
        n, L, H, W, Fl, table.element_size(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "blended_encode_fwd (stamped)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=None,
                    help="samples of the flagship case (default: all 73,728)")
    args_ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode needs a CUDA device")
    device = torch.device("cuda")
    args, _ = flagship_inputs(device)
    if args_ns.samples is not None:
        k = args_ns.samples
        table, code, wy, fx, fz, entry_idx = args[:6]
        args = (table, code[:k], wy[:k], fx[:k], fz[:k], entry_idx[:k]) + args[6:]
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        plain_ms = cuda_time_ms(lambda: he.blended_encode_fwd_cuda(*args))
        stamped_ms = cuda_time_ms(lambda: stamped_fwd(lib, args))
        cuda_lib.check(lib.be_prof_reset(), "be_prof_reset")
        stamped_fwd(lib, args)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 5)()
        cuda_lib.check(lib.be_prof_read(buf), "be_prof_read")
    stages = max(int(buf[4]), 1)
    cycles = {name: buf[i] / stages for i, name in enumerate(PHASES)}
    total = sum(cycles.values())
    result = {"samples": int(args[2].shape[0]),
              "cycles_per_stage": {k: round(v) for k, v in cycles.items()},
              "share": {k: round(v / total, 3) for k, v in cycles.items()},
              "stages": stages, "ms": plain_ms, "ms_stamped": stamped_ms,
              "device": nvidia_smi()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
