"""Build and load the CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` -- one ``nvcc`` per
``.cu`` file, all started together -- and linked into one shared library with
a plain C interface, loaded with ``ctypes``.  The build happens at first
use, into ``build/repro_torch_kernels/`` at the repository root, under a file
name keyed by a hash of the sources: an edited source builds anew, an
unchanged one is loaded from the previous build.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None


class KernelBuildError(RuntimeError):
    """nvcc was not found or refused the sources; the message carries its stderr."""


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels"
    )


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"solver_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once, wait for all; raise with the stderr of
    the first that fails.  Returns the combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [(cmd, proc, *proc.communicate()) for cmd, proc in zip(cmds, procs)]
    for cmd, proc, _, err in outs:
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}"
            )
    return "".join(out + err for _, _, out, err in outs)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources unless a library for this source hash exists.
    Returns its path.  With ``verbose`` nvcc also reports each kernel's
    registers and spills (``-Xptxas -v``), printed to stdout."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build in a temporary directory and rename the library into place:
    # concurrent builds never load a half-written library.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [s for s in sources() if s.suffix == ".cu"]
        objects = [os.path.join(tmp, f"{s.stem}.o") for s in units]
        log = _run_all([
            [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", str(src), "-o", obj]
            for src, obj in zip(units, objects)
        ])
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc_path(), *NVCC_FLAGS, "-shared", "-o", lib, *objects]])
        if verbose:
            print(log, flush=True)
        os.replace(lib, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, i64, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
        dp = ctypes.POINTER(ctypes.c_double)
        lib.rt_max_stages.argtypes = []
        lib.rt_max_stages.restype = i
        lib.rt_error_string.argtypes = [i]
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_stage_accum.argtypes = [i, p, p, p, dp, i, p, i64, i64, p]
        lib.rt_fused_update.argtypes = [i, p, p, p, dp, dp, i, p, p, i64, i64, p]
        lib.rt_error_norm.argtypes = [i, i, p, p, p, p, d, i64, i64, p, d, i64, i64, p, p,
                                      i64, i64, p]
        lib.rt_interp_eval.argtypes = [i, i, p, p, p, p, p, p, p, p, i64, i64, i64, i64, p]
        lib.rt_fused_step_args_size.argtypes = []
        lib.rt_fused_step_args_size.restype = i
        lib.rt_fused_step_max_smem.argtypes = []
        lib.rt_fused_step_max_smem.restype = i
        lib.rt_fused_step.argtypes = [i, i, p, p]
        lib.rt_fused_step_poly.argtypes = [i, i, p, p]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.rt_max_events.argtypes = []
        lib.rt_max_events.restype = i
        lib.rt_masked_bisect_refine.argtypes = [i] + [p] * 14 + [i64, i64, p]
        u64 = ctypes.c_uint64
        lib.rt_fused_event_detect.argtypes = [i, p, p, p, p, u64, u64, i, p, p, i64, p]
        lib.rt_fused_event_commit.argtypes = ([i] + [p] * 9 + [i8p, i] + [p] * 6
                                              + [i64, i64, p])
        lib.rt_linalg_max_smem.argtypes = []
        lib.rt_linalg_max_smem.restype = i
        lib.rt_batched_lu_factor.argtypes = [i, i, p, p, p, i64, i64, p]
        lib.rt_batched_linsolve.argtypes = [i, i, p, p, p, p, p, i64, i64, p]
        lib.rt_fused_newton_iter.argtypes = [i, i] + [p] * 8 + [i64, i64, p]
        lib.rt_masked_newton_update.argtypes = [i] + [p] * 6 + [i64, i64, p]
        lib.rt_flash_attention_fwd.argtypes = [i, i, p, p, p, p, p] + [i64] * 6 + [i, i64, p]
        lib.rt_flash_attention_bwd.argtypes = [i, i] + [p] * 10 + [i64] * 6 + [i, i64, p]
        for name in ("rt_stage_accum", "rt_fused_update", "rt_error_norm", "rt_interp_eval",
                     "rt_fused_step", "rt_fused_step_poly", "rt_masked_bisect_refine",
                     "rt_fused_event_detect", "rt_fused_event_commit", "rt_batched_lu_factor",
                     "rt_batched_linsolve", "rt_fused_newton_iter", "rt_masked_newton_update",
                     "rt_flash_attention_fwd", "rt_flash_attention_bwd"):
            getattr(lib, name).restype = i
        _lib = lib
    return _lib
