"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Every ``kernels/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a``
(all sources at once, one process each), then linked into one shared
library with a plain C interface under ``build/repro_torch/`` at the root
of the checkout.  The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  Nothing here runs at import time: the CPU tests import every module.
Several processes may reach first use at once (ranks started together):
an exclusive ``fcntl`` lock on ``build.lock`` beside the library is held
around the build and the load, so one process builds and the others wait
and load what it built.  The kernel lets go of the lock when its holder
exits, however it exits.

``LAUNCHES`` counts the launches of each kernel.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last ``reset_launches()``.
LAUNCHES: collections.Counter = collections.Counter()

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "rt_powersgd_encode": (_VP, _LL, _LL, _LL, _LL, _VP, _INT, _VP, _VP, _VP,
                           _LL, _INT, _INT, _INT, _LL, _INT, _LL, _VP),
    "rt_powersgd_decode": (_VP, _VP, _LL, _LL, _INT, _VP, _INT, _INT, _LL,
                           _INT, _LL, _VP),
    "rt_pack_signs": (_VP, _LL, _VP, _VP),
    "rt_popcount_votes": (_VP, _INT, _LL, _LL, _VP, _INT, _LL, _VP),
    "rt_qsgd_quantize": (_VP, _VP, _VP, _INT, _LL, _VP, _VP),
    "rt_topk_threshold_mask": (_VP, _VP, _LL, _VP, _VP),
}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _build_lock():
    """Hold the exclusive lock on ``BUILD_DIR/build.lock``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile and link the library unless this source hash is built,
    under the build lock.  Returns its path; the compiler's register
    report is in ``build.log`` beside it."""
    with _build_lock():
        return _build()


def _build() -> Path:
    srcs = _sources()
    out = BUILD_DIR / f"libreprotorch_{_digest(srcs)}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in srcs:
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(tmp / f"{s.stem}.o")]
        procs.append((s, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for s, p in procs:
        text, _ = p.communicate()
        log.append(f"== {s.name}\n{text}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *[str(tmp / f"{s.stem}.o") for s in srcs],
         "-o", str(tmp / out.name)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                           f"{link.stderr}")
    (tmp / out.name).replace(out)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        with _build_lock():
            handle = ctypes.CDLL(str(_build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        handle.rt_error_string.argtypes = [ctypes.c_int]
        handle.rt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_cuda_fp32(name: str, t, dim: int = 1) -> None:
    """Refuse what a streaming kernel does not take: a tensor off the card,
    not fp32, not contiguous, or not ``dim``-D (0 for a scalar that the
    kernel reads through a pointer)."""
    import torch
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous and {dim}-D, got shape "
                         f"{tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def sms(device) -> int:
    """The number of SMs of ``device``, which the launch plans size their
    grids from (read once per device)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
