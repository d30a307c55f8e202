"""Build the CUDA kernels with nvcc and load them with ctypes.

``load()`` compiles every ``csrc/*.cu`` at first use, one nvcc a source,
all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -Xptxas -v -c

and links the objects into one shared library with a plain C interface
(``nvcc -shared``), cached under ``cfd_demo_tpu_torch/_build/``
(git-ignored). The file name carries a hash of the sources and flags, so
a changed source rebuilds. nvcc's output (ptxas register and spill
counts included) is kept beside the library as ``.log``. A failed build
raises with that output. ``-fmad=false`` keeps every multiply and add separately rounded,
as the JAX reference computes them (csrc/common.cuh).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..core.masks import masks_traced
from ..core.unported import BOX_FLOAT64, unported

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
_ROUNDS = [P] * 17 + [I, I, F, F, F, F, F, F, I, F, I, F, I, F, F, I, P]
# (name, argtypes) of every C entry point; all return int.
_SIGNATURES = {
    "cfd_predict_div_tiled": [P] * 8 + [I] * 4 + [F] * 4 + [I] * 8 + [P],
    "cfd_jacobi_partials": [I, I],
    "cfd_jacobi_fused_k": [P] * 5 + [I] * 3 + [F] * 4 + [I, P],
    "cfd_jacobi_tile": [P],
    "cfd_jacobi_fused_k_shard": [P] * 6 + [I] * 11 + [F] * 4 + [P],
    "cfd_correct_bc_fused_partials": [I, I],
    "cfd_correct_bc_fused": [P] * 15 + [I] * 6 + [F, F, I, F, F, I, P],
    "cfd_correct_div": [P] * 9 + [I, I, F, F, P],
    "cfd_rounds": _ROUNDS,
    "cfd_rounds_cluster": _ROUNDS[:-1] + [I, P],
    "cfd_rounds_cluster_admit": [I, I, I, I],
    "cfd_rounds_slab": _ROUNDS[:-1] + [I, P, ctypes.c_longlong, P, I, P, P],
    "cfd_mgp_res": [P] * 7 + [I] * 3 + [F] * 7 + [I, P],
    "cfd_mgp_restrict": [P] * 7 + [I] * 3 + [F] * 7 + [I, P],
    "cfd_mgp_corr": [P] * 9 + [I] * 3 + [F] * 7 + [I, P],
    "cfd_cc_sweeps": [P] * 5 + [I] * 3 + [F] * 8 + [I, P],
    "cfd_substep_batch_smem": [I, I],
    "cfd_substep_batch": [P] * 16 + [I] * 3 + [F] * 9 + [I, I, F, I, F, P],
    "cfd_substep_batch_cluster": [P] * 16 + [I] * 3 + [F] * 9 + [I, I, F, I, F, I, P],
    "cfd_substep_batch_cluster_admit": [I, I, I, I],
    "cfd_jacobi_batch": [P] * 8 + [I] * 4 + [F] * 5 + [P],
    "cfd_jacobi_batch_cluster": [P] * 6 + [I] * 4 + [F] * 5 + [I, P],
    "cfd_jacobi_batch_cluster_admit": [I, I, I],
    "cfd_sor_partials": [I, I],
    "cfd_sor_fused_k": [P] * 4 + [I] * 3 + [F] * 5 + [P],
    "cfd_sor_fused_k_shard": [P] * 4 + [I] * 11 + [F] * 5 + [P],
    "cfd_sor_rb2_partials": [I, I],
    "cfd_sor_fused_k_rb2": [P] * 6 + [I] * 3 + [F] * 5 + [P],
    "cfd_mg_smooth": [P] * 4 + [I] * 3 + [F] * 3 + [P],
    "cfd_mg_restrict": [P] * 3 + [I] * 2 + [F] * 3 + [P],
    "cfd_mg_prolong_add": [P] * 3 + [I] * 3 + [P],
    "cfd_mgp_smooth": [P] * 4 + [I] * 3 + [F] * 4 + [I, P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcfdkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    lib = library_path()
    if not lib.exists():
        compile_library(lib, [s for s in _sources() if s.suffix == ".cu"], FLAGS)
    return lib


def compile_library(lib: Path, sources, flags) -> None:
    """nvcc each source with ``flags`` (all started together), link them
    into the shared library ``lib`` and keep nvcc's output beside it as
    ``.log``; raises with that output if a step fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=lib.parent) as work:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(work, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *flags, "-c", "-o", obj, str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, proc in procs:  # every compile ends before any raise
            out = proc.communicate()[0]
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = os.path.join(work, lib.name)
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{log}")
        lib.with_suffix(".log").write_text(
            f"built in {time.perf_counter() - t0:.1f} s\n{log}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cfd_error_string.argtypes = [I]
    lib.cfd_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        text = load().cfd_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({text})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def mask_ptrs(grid, semantics, device):
    """Device pointers of the scene's four obstacle masks (core.masks
    ``masks_traced``: one byte a face, cached per grid, semantics and
    device, so they outlive the launch), or four None (a null pointer:
    no obstacles)."""
    return tuple(None if m is None else m.data_ptr()
                 for m in masks_traced(grid, semantics, device))


# ---------------------------------------------------------------------------
# Wrapper helpers
# ---------------------------------------------------------------------------

def on_cpu(what: str, shape_of: dict) -> bool:
    """Validate a kernel wrapper's inputs and say where they lie.

    ``shape_of`` maps an argument name to (tensor, expected shape). All
    must be contiguous f32 on one device, CPU or CUDA; True means CPU,
    where the wrapper runs its plain version."""
    device = None
    for name, (t, shape) in shape_of.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: {name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise unported(f"{what}: {name} of dtype {t.dtype}", BOX_FLOAT64)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {device}; expected cpu or cuda")
    return device.type == "cpu"


def device_scalars(device, *xs) -> torch.Tensor:
    """A contiguous f32 vector of the scalars ``xs`` (floats or 0-d
    tensors already on ``device``) on ``device``, built without a host
    synchronisation."""
    return torch.stack([
        x.to(torch.float32).reshape(()) if isinstance(x, torch.Tensor)
        else torch.full((), float(x), dtype=torch.float32, device=device)
        for x in xs])


def scene_scalars(device, batch: int, *xs) -> torch.Tensor:
    """A contiguous f32 (batch, len(xs)) tensor on ``device``: column c
    holds ``xs[c]`` for every scene, a float, a 0-d tensor (the same for
    all) or a (batch,) tensor (one per scene) already on ``device``.
    Built without a host synchronisation; :func:`device_scalars` is the
    one-scene form."""
    cols = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.dim() > 1 or (x.dim() == 1 and x.shape[0] != batch):
                raise ValueError(f"a per-scene scalar has shape {tuple(x.shape)}; "
                                 f"expected () or ({batch},)")
            cols.append(x.to(torch.float32).reshape(-1).expand(batch))
        else:
            cols.append(torch.full((batch,), float(x), dtype=torch.float32,
                                   device=device))
    return torch.stack(cols, dim=1).contiguous()
