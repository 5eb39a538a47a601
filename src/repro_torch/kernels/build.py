"""Build, load and launch plumbing of the port's CUDA kernels: `nvcc`
compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source, all
started together), links them into one shared library with a plain C
interface, and `ctypes` loads it.

The build runs at first use (`load`), never at import, from the sources in
the checkout only, into ``build/repro_torch/<hash>/`` at the root of the
checkout (listed in ``.gitignore``). The hash covers the sources and the
flags, so an edited kernel is rebuilt and an unchanged one is not.

Nothing here runs at import: the CPU tests import every module on a
machine with neither `nvcc` nor a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch import device as device_lib

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit's default location, else
    the first `nvcc` on PATH."""
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _run_all(cmds: list[list[str]], log: list[str]) -> None:
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode})\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build(out_dir: pathlib.Path, csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Compile every ``csrc/*.cu`` and link into ``out_dir``; returns the
    library's path. The library is written under a temporary name and
    renamed into place. ``csrc`` defaults to this checkout's sources (another
    checkout's, to compare two builds)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    units = sorted(pathlib.Path(csrc).glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in units]
    log: list[str] = []
    t0 = time.perf_counter()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(units, objs)], log)
    tmp_lib = out_dir / f"{LIB_NAME}.{tag}"
    _run_all([[nvcc, NVCC_FLAGS[0], "-shared", "-o", str(tmp_lib),
               *map(str, objs)]], log)
    log.append(f"build seconds: {time.perf_counter() - t0:.3f}\n")
    (out_dir / "build.log").write_text("".join(log))
    for obj in objs:
        obj.unlink()
    lib = out_dir / LIB_NAME
    os.replace(tmp_lib, lib)
    return lib


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.serve_topk_window_launch.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.serve_topk_window_launch.restype = i32
    lib.serve_topk_launch.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.serve_topk_launch.restype = i32
    lib.serve_topk_rows_launch.argtypes = [ptr] * 9 + [i32] * 11 + [ptr]
    lib.serve_topk_rows_launch.restype = i32
    lib.serve_topk_window_quant_launch.argtypes = [ptr] * 7 + [i32] * 9 + [ptr]
    lib.serve_topk_window_quant_launch.restype = i32
    lib.serve_topk_tiled_quant_launch.argtypes = [ptr] * 9 + [i32] * 11 + [ptr]
    lib.serve_topk_tiled_quant_launch.restype = i32
    lib.topk_peruser_launch.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
    lib.topk_peruser_launch.restype = i32
    lib.dmf_fused_step_launch.argtypes = [ptr] * 10 + [i32] * 2 + [f32] * 4 + [ptr]
    lib.dmf_fused_step_launch.restype = i32
    lib.dmf_fused_step_dp_launch.argtypes = [ptr] * 11 + [i32] * 2 + [f32] * 5 + [ptr]
    lib.dmf_fused_step_dp_launch.restype = i32
    lib.gauss_counter_launch.argtypes = [ptr] * 2 + [i32] * 2 + [u32] + [i32] * 2 + [ptr]
    lib.gauss_counter_launch.restype = i32
    lib.counter_words_launch.argtypes = [ptr] * 3 + [i32] * 2 + [u32] + [i32] * 2 + [ptr]
    lib.counter_words_launch.restype = i32
    lib.dp_clip_noise_launch.argtypes = [ptr] * 3 + [i32] * 2 + [u32] + [f32] * 2 + [ptr]
    lib.dp_clip_noise_launch.restype = i32
    lib.topk_shared_launch.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
    lib.topk_shared_launch.restype = i32
    lib.dmf_grads_launch.argtypes = [ptr] * 8 + [i32] * 2 + [f32] * 3 + [i32] + [ptr]
    lib.dmf_grads_launch.restype = i32
    lib.gossip_mix_count_launch.argtypes = [ptr] * 2 + [i32] * 2 + [ptr] * 4
    lib.gossip_mix_count_launch.restype = i32
    lib.gossip_mix_sparse_launch.argtypes = [ptr] * 3 + [i32] * 2 + [ptr] * 4
    lib.gossip_mix_sparse_launch.restype = i32
    lib.gossip_mix_dense_launch.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    lib.gossip_mix_dense_launch.restype = i32
    lib.dmf_step_scratch.argtypes = [i32]
    lib.dmf_step_scratch.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    lib = BUILD_ROOT / source_hash() / LIB_NAME
    if not lib.is_file():
        lib = build(lib.parent)
    return _declare(ctypes.CDLL(str(lib)))


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build, or '' if it was not built by this checkout."""
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.is_file() else ""


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the same CUDA device (launch the
    kernel), False if every tensor lies on the CPU (run the plain
    version); raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cpu":
        device_lib.settle_cpu()
    return dev.type == "cuda"


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_dtype(name: str, arg: str, t: torch.Tensor, *dtypes: torch.dtype) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                        f"{' or '.join(map(str, dtypes))}")


def require_shape(name: str, arg: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def launch(name: str, device: torch.device, fn: str, *args) -> None:
    """Call the library's C launch function ``fn`` with ``args`` and the
    raw `cudaStream_t` of PyTorch's current stream on ``device``; raise if
    it returns a CUDA error."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
