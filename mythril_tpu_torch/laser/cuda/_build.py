"""Build and load the port's CUDA kernels; device checks for entry points.

Every kernel source lives in ``mythril_tpu_torch/csrc/``. At first use,
each ``*.cu`` file there is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, all of them in parallel, into
``mythril_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
ctypes. Nothing includes PyTorch's headers, so a build takes seconds,
not minutes. Pointers travel as 64-bit ``c_void_p``; each C entry point
launches on the caller's stream and returns ``cudaGetLastError()``,
which ``check`` raises on.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("keccak", "step", "inloop", "megakernel")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_LIBS = {}
BUILD_SECONDS = {}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must exist if asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mythril_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_on(device, *tensors) -> torch.device:
    """Resolve ``device`` and insist that every tensor lies on it."""
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"tensor on {t.device}, entry point asked to run on {dev}")
    return dev


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


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
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return dict(BUILD_SECONDS)


def library(name: str) -> ctypes.CDLL:
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


def check(rc: int, what: str, lib_name: str = "keccak") -> None:
    if rc != 0:
        msg = library(lib_name).mt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
