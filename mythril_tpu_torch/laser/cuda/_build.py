"""Build and load the port's CUDA kernels; device checks for entry points.

Every kernel source lives in ``mythril_tpu_torch/csrc/``. At first use,
each ``*.cu`` file there is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, all of them in parallel, into
``mythril_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
ctypes. Nothing includes PyTorch's headers, so a build takes seconds,
not minutes. Pointers travel as 64-bit ``c_void_p``; each C entry point
launches on the caller's stream and returns ``cudaGetLastError()``,
which ``check`` raises on.

Every failure of a kernel or of its build, and every device or dtype
misuse a wrapper detects, raises ``KernelError``. A fault inside a
running kernel (an illegal address, a trap) is not seen at its launch:
CUDA reports it at the next call that synchronises or launches, where
torch raises its own error. ``sync_point`` turns that error into
``KernelError`` where the port reads results back, and
``reraise_kernel_fault`` does so in every handler. The host half copied
from the reference degrades to host rounds on most exceptions; its
handlers call ``reraise_kernel_fault`` first, so a broken kernel
surfaces instead of turning into a silent host run.

Threads: the analysis service launches from several threads (a round
leader steps the batch while other jobs' host phases call K5). A thread
that needs a library while another builds it waits for that build
(``_BUILD_LOCK``) instead of starting a second nvcc into the same file.
Launch helpers key their kept scratch by ``stream_key``: loops on two
streams never share a buffer, and launches on one stream run in order.
"""

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("keccak", "step", "inloop", "megakernel", "solve", "transfer", "hist", "slice", "mesh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_LIBS = {}
BUILD_SECONDS = {}
_BUILD_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A kernel failed to build, launch or run, or a wrapper was misused."""


# how torch words a CUDA runtime error it met after a launch (a plain
# RuntimeError in older releases, torch.AcceleratorError in newer ones)
_CUDA_FAULT = re.compile(r"CUDA (\w+ )?error|CUDA kernel errors|device-side assert")


def as_kernel_error(exc: BaseException):
    """The KernelError that ``exc`` stands for, or None when it is none.

    Allocation failures are not kernel faults: the reference degrades
    them to host rounds, and so does the port."""
    if isinstance(exc, KernelError):
        return exc
    text = str(exc)
    if isinstance(exc, torch.cuda.OutOfMemoryError) or "out of memory" in text:
        return None
    accel = getattr(torch, "AcceleratorError", ())
    if isinstance(exc, accel) or (isinstance(exc, RuntimeError) and _CUDA_FAULT.search(text)):
        err = KernelError(f"a kernel faulted (reported after its launch): {text}")
        err.__cause__ = exc
        return err
    return None


def reraise_kernel_fault(exc: BaseException) -> None:
    """Raise the KernelError ``exc`` stands for; return if it is none.
    Every degrade handler around a device call calls this first."""
    err = as_kernel_error(exc)
    if err is not None:
        raise err


@contextlib.contextmanager
def sync_point():
    """Wrap a read of device results: a kernel's fault shows up there
    first, and leaves as KernelError."""
    try:
        yield
    except Exception as e:
        reraise_kernel_fault(e)
        raise


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must exist if asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise KernelError(
            "mythril_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise KernelError(f"unsupported device {device!r}")
    return dev


def check_on(device, *tensors) -> torch.device:
    """Resolve ``device`` and insist that every tensor lies on it: on its
    type, and on its card where ``device`` names one ("cuda:1"; a bare
    "cuda" is whichever card the tensors are on)."""
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
            raise KernelError(f"tensor on {t.device}, entry point asked to run on {dev}")
    return dev


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fn), "rb") as fh:
            h.update(fn.encode() + fh.read())
    return h.hexdigest()[:12]


def _lib_path(name: str, digest: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build_all() -> dict:
    """Compile every source that has no current library, one nvcc per
    source, all started together. Returns {name: seconds} of this call's
    compiles and writes each compiler log next to its library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _digest()
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name, digest)
        if os.path.exists(out):
            continue
        tmp = out + f".tmp{os.getpid()}"
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log, time.time())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        BUILD_SECONDS[name] = time.time() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = "\n".join(open(os.path.join(BUILD_DIR, f"{n}.log")).read()[-4000:] for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{logs}")
    return dict(BUILD_SECONDS)


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        with _BUILD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = _lib_path(name, _digest())
                if not os.path.exists(path):
                    build_all()
                lib = ctypes.CDLL(path)
                lib.mt_error_string.argtypes = [ctypes.c_int]
                lib.mt_error_string.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def host_emulation() -> ctypes.CDLL:
    """The kernels' lane logic compiled as host C++ (``csrc/host_emu.cpp``
    with ``-DMT_HOST_EMU``, by g++): lets the CPU tests hold the CUDA
    sources' arithmetic against the twins. Not a path of the port."""
    lib = _LIBS.get("host_emu")
    if lib is None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"libhost_emu_{_digest()}.so")
        if not os.path.exists(out):
            tmp = out + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-DMT_HOST_EMU", "-I", CSRC,
                 "-o", tmp, os.path.join(CSRC, "host_emu.cpp")],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, out)
        lib = _LIBS["host_emu"] = ctypes.CDLL(out)
    return lib


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def stream_key(device) -> int:
    """The calling thread's current stream on ``device`` (0 on the CPU)."""
    dev = torch.device(device)
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else 0


def check(rc: int, what: str, lib_name: str) -> None:
    """Raise KernelError when a C entry point of ``lib_name`` returned a
    nonzero ``cudaGetLastError``."""
    if rc != 0:
        msg = library(lib_name).mt_error_string(rc).decode()
        raise KernelError(f"{what}: CUDA error {rc} ({msg})")
