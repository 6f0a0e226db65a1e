"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``), named by a hash of its sources and flags under
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), and is loaded with ``ctypes``. Nothing here runs at import:
the CPU tests import every module of the port on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``launch`` raises on a non-zero code and only then counts the launch in
``LAUNCHES``."""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = (
    "paged_decode", "swa_decode", "flash_prefill", "flash_suffix_prefill", "quantize",
    "topk_compress", "dp_clip",
)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per C entry point since process start (or the caller's
# last reset): the proof that a run went through the kernels.
LAUNCHES: dict[str, int] = {
    "paged_decode": 0, "flash_prefill": 0, "suffix_prefill": 0,
    "paged_decode_int8": 0, "suffix_prefill_int8": 0, "int8_encode": 0,
    "int8_roundtrip": 0, "topk_sparsify": 0, "sq_norm": 0, "clip_noise": 0,
    "paged_decode_ring": 0, "swa_decode": 0, "kv_write_int8": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every C entry point: pointers and the stream are c_void_p
SIGNATURES = {
    "paged_decode": (P,) * 7 + (I,) * 9 + (F, P),
    "flash_prefill": (P,) * 4 + (I,) * 9 + (F, P),
    "suffix_prefill": (P,) * 8 + (I,) * 9 + (F, P),
    "paged_decode_int8": (P,) * 9 + (I,) * 9 + (F, P),
    "suffix_prefill_int8": (P,) * 10 + (I,) * 9 + (F, P),
    "int8_encode": (P, P, P, L, L, I, P),
    "int8_roundtrip": (P, P, L, P),
    "topk_sparsify": (P, P, L, I, P),
    "sq_norm": (P, P, P, P, L, I, P),
    "clip_noise": (P, P, P, P, L, F, I, P),
    "paged_decode_ring": (P,) * 6 + (I,) * 9 + (F, P),
    "swa_decode": (P,) * 6 + (I,) * 8 + (F, P),
    "kv_write_int8": (P,) * 9 + (L,) * 4 + (I,) * 7 + (P,),
}
ENTRY = {
    "paged_decode": "paged_decode",
    "flash_prefill": "flash_prefill",
    "suffix_prefill": "flash_suffix_prefill",
    "paged_decode_int8": "paged_decode",
    "suffix_prefill_int8": "flash_suffix_prefill",
    "int8_encode": "quantize",
    "int8_roundtrip": "quantize",
    "topk_sparsify": "topk_compress",
    "sq_norm": "dp_clip",
    "clip_noise": "dp_clip",
    "paged_decode_ring": "paged_decode",
    "swa_decode": "swa_decode",
    "kv_write_int8": "quantize",
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a CUDA machine")


def library_path(source: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in (CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:16]}.so"


def build_all(sources=KERNELS) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together. Returns the compiler's register/shared-memory report
    (``-Xptxas -v``) per built source; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        so = library_path(source)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, so)
    reports, failed = {}, []
    for source, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        reports[source] = out
        if proc.returncode != 0:
            failed.append(f"{source}.cu:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _lib(name: str) -> ctypes.CDLL:
    source = ENTRY[name]
    if source not in _LIBS:
        so = library_path(source)
        if not so.exists():
            build_all((source,))
        lib = ctypes.CDLL(str(so))
        for entry, src in ENTRY.items():
            if src == source:
                fn = getattr(lib, entry)
                fn.argtypes = SIGNATURES[entry]
                fn.restype = ctypes.c_int
        _LIBS[source] = lib
    return _LIBS[source]


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on PyTorch's current stream (appended as
    the last argument) and count the launch; raise on a CUDA error."""
    fn = getattr(_lib(name), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def check_cuda(name: str, **tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous; raise otherwise.
    The int8 pools and their f32 scale planes go through here like any
    other operand (``check_pool`` checks their types and shapes)."""
    device = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, the kernel needs a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {device}")



def check_tma(name: str, **tensors: torch.Tensor) -> None:
    """Operands of the tensor-core kernels (read through TMA tensor maps or
    with 16-byte loads) start at 16-byte aligned addresses; raise otherwise.
    Their strides need no check: ``check_cuda`` takes contiguous tensors
    only, whose rows of ``HEAD_DIMS`` bf16 (64 to 320 bytes) are multiples of
    16 bytes."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start at a 16-byte aligned address")


def sass_opcodes(source: str) -> set[str]:
    """The SASS opcodes (``cuobjdump -sass``) of a built library: e.g.
    ``HGMMA`` (tensor-core wgmma) and ``UTMALDG`` (TMA load)."""
    so = library_path(source)
    if not so.exists():
        build_all((source,))
    cuobjdump = pathlib.Path(_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                         check=True).stdout
    ops = set()
    for line in out.splitlines():
        # "        /*0120*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], ..."
        parts = line.split("*/", 1)
        if len(parts) == 2 and parts[0].strip().startswith("/*"):
            words = parts[1].replace(";", " ").split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                ops.add(words[0].split(".")[0])
    return ops


def check_pool(name: str, q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
               k_scale: torch.Tensor | None, v_scale: torch.Tensor | None) -> None:
    """The pools' types against the query's: fp pools (no scales) share q's
    dtype; int8 pools come with both f32 scale planes of shape
    ``pool.shape[:-1]`` (one scale per slot per kv head). Raise otherwise."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both scale planes or neither")
    if k_scale is None:
        if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise TypeError(f"{name}: q and the pools must share one dtype")
        return
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"{name}: scale planes go with int8 pools, got {k_pool.dtype}")
    for key, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s.dtype != torch.float32 or s.shape != k_pool.shape[:-1]:
            raise ValueError(f"{name}: {key} must be float32 {tuple(k_pool.shape[:-1])}, got "
                             f"{s.dtype} {tuple(s.shape)}")
