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
  """Compile `csrc/<source>` unless a library of this exact source exists."""
  return build_all([source])[0]


def build_all(sources=None) -> list:
  """Compile each of `sources` (default: every `csrc/*.cu`) that has no
  library of its exact source yet, one `nvcc` per source, all at once.
  Each output is written under a temporary name and renamed, so processes
  that build at the same time never load a half-written file."""
  if sources is None:
    sources = sorted(p.name for p in SOURCE_DIR.glob("*.cu"))
  outs = [library_path(s) for s in sources]
  todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
  if not todo:
    return outs
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = find_nvcc()
  jobs = []
  try:
    for source, out in todo:
      fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
      os.close(fd)
      cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE_DIR / source)]
      jobs.append((source, out, tmp, subprocess.Popen(
          cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for source, out, tmp, proc in jobs:
      _, err = proc.communicate()
      if proc.returncode != 0:
        errors.append(f"nvcc failed for {source}:\n{err}")
      else:
        os.replace(tmp, out)
    if errors:
      raise RuntimeError("\n".join(errors))
  finally:
    for _, _, tmp, proc in jobs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
      if os.path.exists(tmp):
        os.remove(tmp)
  return outs


def load(source: str) -> ctypes.CDLL:
  """The loaded library of `csrc/<source>`, built on first use."""
  lib = _LOADED.get(source)
  if lib is None:
    lib = ctypes.CDLL(str(build(source)))
    _LOADED[source] = lib
  return lib
