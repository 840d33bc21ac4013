"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/mapdit_tpu_torch/<name>-<hash>.so`` under the checkout root (the
hash of the source and of the ``csrc/*.cuh`` headers keeps a stale library
from being loaded). All sources
build at once, one nvcc process each, started together. Nothing is built or
imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mapdit_tpu_torch"
SOURCES = ("mp_gemm", "cosine_attention", "attn_branch_bwd", "fused_attention", "dw_gemm", "dit_stack", "dit_block_tp",
           "attn_branch", "attn_branch_f32")
# sources a source includes besides the headers (attn_branch_f32.cu is
# attn_branch.cu's f32 instances)
INCLUDES = {"attn_branch_f32": ("attn_branch",)}
# measurement-only sources, built when a tool asks for their library
PROBES = ("kstep_probe",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_attention": {
        "fused_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P], ctypes.c_int),
        "fused_attention_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
        "fused_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "mp_gemm": {
        "mp_gemm": (
            [_P, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P],
            ctypes.c_int,
        ),
        "mp_gemm_splits": ([_I, _I, _I], ctypes.c_int),
        "mp_gemm_f32": ([_P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P],
                        ctypes.c_int),
        "mp_gemm_f32_splits": ([_I, _I, _I], ctypes.c_int),
        "mp_gemm_gate_residual_bwd": ([_P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _P, _I, _I, _P, _P, _P],
                                      ctypes.c_int),
        "mp_gemm_f32_gate_residual_bwd": ([_P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _I, _P, _I, _I, _P, _P, _P],
                                          ctypes.c_int),
        "mp_gemm_gate_partial_floats": ([_I, _I, _I], ctypes.c_int64),
        "mp_gemm_error_string": ([_I], ctypes.c_char_p),
    },
    "dw_gemm": {
        "dw_gemm": ([_P, _P, _P, _P, _I, _I, _I, _F, _P], ctypes.c_int),
        "dw_gemm_splits": ([_I, _I, _I], ctypes.c_int),
        "dw_gemm_planned": ([_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P], ctypes.c_int),
        "dw_gemm_error_string": ([_I], ctypes.c_char_p),
    },
    "dit_stack": {
        "dit_stack": ([_P] * 17 + [_I] * 12 + [_F, _F, _P, _P], ctypes.c_int),
        "dit_stack_f32": ([_P] * 17 + [_I] * 12 + [_F, _F, _P, _P], ctypes.c_int),
        "dit_stack_resident_ctas": ([_I], ctypes.c_int),
        "dit_stack_f32_resident_ctas": ([_I], ctypes.c_int),
        "dit_stack_smem_bytes": ([], ctypes.c_int),
        "dit_stack_error_string": ([_I], ctypes.c_char_p),
    },
    "dit_block_tp": {
        "tp_attn": ([_P] * 5 + [_P, _I, _P, _I, _I] + [_P] * 11 + [_I] * 6 + [_F, _P, _P], ctypes.c_int),
        "tp_mlp": ([_P] * 3 + [_P, _I, _P, _I, _I] + [_P] * 8 + [_I] * 5 + [_F, _F, _P, _P], ctypes.c_int),
        "dit_block_tp_plan_words": ([], ctypes.c_int),
        "mlp_branch": ([_P] * 3 + [_P, _I, _P, _I, _P, _I, _I] + [_P] * 8 + [_I] * 5 + [_F, _F, _P, _P], ctypes.c_int),
        "mlp_branch_resident_ctas": ([], ctypes.c_int),
        "dit_block_tp_resident_ctas": ([_I], ctypes.c_int),
        "dit_block_tp_error_string": ([_I], ctypes.c_char_p),
    },
    "attn_branch": {
        "attn_branch_fwd": ([_P] * 4 + [_I, _P, _I, _P, _I, _I] + [_P] * 7 + [_I] * 5 + [_F, _P, _P], ctypes.c_int),
        "attn_branch_res_fwd": ([_P] * 4 + [_I, _P, _I, _P, _I, _I] + [_P] * 8 + [_I] * 5 + [_F, _P, _P],
                                ctypes.c_int),
        "attn_branch_bwd": ([_P, _I] + [_P] * 4 + [_I, _P, _I, _P, _I, _I] + [_P] * 15 + [_I] * 5 + [_F] * 3
                            + [_P, _P], ctypes.c_int),
        "attn_branch_resident_ctas": ([_I], ctypes.c_int),
        "attn_branch_plan_words": ([], ctypes.c_int),
        "attn_branch_error_string": ([_I], ctypes.c_char_p),
    },
    "attn_branch_f32": {
        "attn_branch_fwd_f32": ([_P] * 4 + [_I, _P, _I, _P, _I, _I] + [_P] * 7 + [_I] * 5 + [_F, _P, _P], ctypes.c_int),
        "attn_branch_res_fwd_f32": ([_P] * 4 + [_I, _P, _I, _P, _I, _I] + [_P] * 8 + [_I] * 5 + [_F, _P, _P],
                                    ctypes.c_int),
        "attn_branch_bwd_f32": ([_P, _I] + [_P] * 4 + [_I, _P, _I, _P, _I, _I] + [_P] * 15 + [_I] * 5 + [_F] * 3
                                + [_P, _P], ctypes.c_int),
        "attn_branch_f32_resident_ctas": ([_I], ctypes.c_int),
        "attn_branch_plan_words": ([], ctypes.c_int),
        "attn_branch_error_string": ([_I], ctypes.c_char_p),
    },
    "kstep_probe": {
        "kstep_probe": ([_I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P], ctypes.c_int),
        "kstep_probe_error_string": ([_I], ctypes.c_char_p),
    },
    "cosine_attention": {
        "cosine_attention": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "cosine_attention_f32": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "cosine_attention_error_string": ([_I], ctypes.c_char_p),
    },
    "attn_branch_bwd": {
        "attention_bwd": ([_P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
        "attention_bwd_f32": ([_P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
        "attention_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "modulate_fwd": ([_P, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P], ctypes.c_int),
        "modulate_fwd_f32": ([_P, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P], ctypes.c_int),
        "modulate_bwd_partials": ([_I, _I], ctypes.c_int),
        "modulate_bwd": (
            [_P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
            ctypes.c_int,
        ),
        "attn_branch_bwd_error_string": ([_I], ctypes.c_char_p),
    },
}

_LOCK = threading.Lock()
_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(name: str) -> pathlib.Path:
    # the headers are hashed with every source, so none is built stale
    parts = [CSRC / f"{name}.cu", *(CSRC / f"{inc}.cu" for inc in INCLUDES.get(name, ())),
             *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: tuple = SOURCES) -> dict:
    """Compile every source of ``names`` (the kernels' by default) whose
    library is missing, all in parallel, and return ``{name: seconds}`` for
    the ones compiled. Raises with nvcc's output if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, target)
    start = time.perf_counter()
    seconds, failures = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all kernel
    sources first if needed (a probe's only itself), with argument and
    return types declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,) if name in PROBES else SOURCES)
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
