"""Build the CUDA kernels into one shared library with a plain C interface.

The sources under ``csrc/`` are compiled for ``sm_90a`` at first use, one
``nvcc`` process per source, all started together, then linked into one
``.so`` that is loaded with :mod:`ctypes`. The library lands in
``build/repro_torch/<key>/`` at the root of the checkout, where ``key``
hashes the sources and the flags, so a changed source builds anew and an
unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("fixedpoint.cu", "packet_accum.cu", "flash_attention.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"
# No --use_fast_math: dequantize needs a correctly rounded division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# payload, ids, id bytes, N, slots, D, out, stream
_ACCUM_ARGS = (_P, _P, _I, ctypes.c_int64, _I, _I, _P, _P)
# leaf, scratch, out, segment offsets, src, dst, segments, D, P, B, stream
_GATHER_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_int64, _P)
# q, k, v, out, strides (host int64[12]), B, H, KV, S, D, causal, window,
# scale, stream
_FLASH_ARGS = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
               ctypes.c_float, _P)
_SIGNATURES = {
    "repro_quantize_f32": (_P, _P, _P, ctypes.c_int64, _P),
    "repro_quantize_bf16": (_P, _P, _P, ctypes.c_int64, _P),
    "repro_dequantize": (_P, _P, _P, ctypes.c_int64, _P),
    "repro_packet_accumulate_i32": _ACCUM_ARGS,
    "repro_packet_accumulate_f32": _ACCUM_ARGS,
    "repro_packet_accumulate_bf16": _ACCUM_ARGS,
    "repro_packet_accumulate_gather_i32": _GATHER_ARGS,
    "repro_packet_accumulate_gather_f32": _GATHER_ARGS,
    "repro_flash_attention_bf16": _FLASH_ARGS,
    "repro_flash_attention_f32": _FLASH_ARGS,
}


@dataclass(frozen=True)
class Build:
    """The loaded library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    seconds: float     # compile + link time; 0.0 when loaded from the cache
    log: str           # nvcc's output of the build, ``-Xptxas -v`` included


_lock = threading.Lock()
_build: Build | None = None


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from the CUDA toolkit PyTorch finds
    (``$CUDA_HOME``, then the toolkit's default location)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.access(os.path.join(CUDA_HOME, "bin", "nvcc"), os.X_OK):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "repro_torch CUDA kernels cannot be built")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> str:
    """Compile every source in parallel, then link; returns nvcc's output."""
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== nvcc {name}\n{out}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    link = [nvcc, "-shared", *(str(obj) for _, obj, _ in procs),
            "-o", str(out_dir / LIB_NAME)]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    logs.append(f"== nvcc -shared\n{res.stdout}")
    if res.returncode:
        raise RuntimeError("linking the kernels failed:\n" + "\n".join(logs))
    return "\n".join(logs)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Build:
    """Build (or load the cached build of) the kernels' library, once per
    process."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        final = BUILD_ROOT / _key()
        seconds = 0.0
        if not (final / LIB_NAME).exists():
            nvcc = find_nvcc()
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            try:
                (tmp / LOG_NAME).write_text(_compile(nvcc, tmp))
                try:
                    tmp.rename(final)  # atomic; another process may have won
                except OSError:
                    if not (final / LIB_NAME).exists():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            seconds = time.perf_counter() - t0
        _build = Build(lib=_load(final / LIB_NAME), path=final / LIB_NAME,
                       seconds=seconds, log=(final / LOG_NAME).read_text())
        return _build


def ptxas_resources(log: str, kernel: str) -> dict:
    """``{template argument: (registers, spill bytes)}`` of each
    instantiation ``kernel<N>`` that ``-Xptxas -v`` reports in ``log``."""
    out, arg = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"{kernel}ILi(\d+)E", line)
            arg = int(m.group(1)) if m else None
        elif arg is not None and "spill stores" in line:
            spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
            out[arg] = (None, spills)
        elif arg is not None and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[arg] = (regs, out.get(arg, (None, 0))[1])
            arg = None
    return out


def library() -> ctypes.CDLL:
    return build().lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")
