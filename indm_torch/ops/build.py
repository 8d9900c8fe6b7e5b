"""Build the port's CUDA sources at first use and load them with ctypes.

Each `indm_torch/csrc/*.cu` file has a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/kernels/` at the root of the
checkout, under a name that carries a hash of the source, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def find_nvcc() -> str:
  for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                     "the port's kernels")


def library_path(source: str) -> Path:
  src = SOURCE_DIR / source
  digest = hashlib.sha256(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(source: str) -> Path:
  """Compile `csrc/<source>` unless a library of this exact source exists.
  The output is written under a temporary name and renamed, so processes
  that build at the same time never load a half-written file."""
  out = library_path(source)
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE_DIR / source)]
  try:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, out)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return out


def load(source: str) -> ctypes.CDLL:
  """The loaded library of `csrc/<source>`, built on first use."""
  lib = _LOADED.get(source)
  if lib is None:
    lib = ctypes.CDLL(str(build(source)))
    _LOADED[source] = lib
  return lib
