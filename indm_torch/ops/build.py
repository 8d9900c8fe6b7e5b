"""Build the port's CUDA sources at first use and load them with ctypes.

Each `indm_torch/csrc/*.cu` file has a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into `build/kernels/` at the root of the
checkout, under a name that carries a hash of the source and of the
`csrc/*.cuh` headers it includes, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _source_files(source: str) -> list:
  """`csrc/<source>` and every `csrc/` header it includes with quotes,
  directly or through another header, in the order first met."""
  files, todo = [], [source]
  while todo:
    name = todo.pop(0)
    if name not in files:
      files.append(name)
      todo += [m.decode() for m in
               _INCLUDE.findall((SOURCE_DIR / name).read_bytes())]
  return files


def library_path(source: str) -> Path:
  """The library of `csrc/<source>`, named by a hash of the source, of the
  headers it includes and of the compiler flags."""
  h = hashlib.sha256()
  for name in _source_files(source):
    h.update(name.encode() + b"\0" + (SOURCE_DIR / name).read_bytes())
  h.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


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


def ptxas_report(source: str) -> str:
  """What `nvcc -Xptxas -v` says of each kernel of `csrc/<source>` (its
  registers, shared memory and spills), compiled with the library's flags
  to a cubin that is thrown away."""
  flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                              "-fPIC")]
  with tempfile.TemporaryDirectory() as tmp:
    proc = subprocess.run(
        [find_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
         os.path.join(tmp, "k.cubin"), str(SOURCE_DIR / source)],
        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
  return proc.stderr


def loaded(source: str):
  """The library of `csrc/<source>` if this process has loaded it, else
  None (nothing is built)."""
  return _LOADED.get(source)


def launch(fn, x, *args):
  """fn(*args, stream) for a loaded kernel entry point, on the device of
  the tensor x and its current stream: the device is switched only where
  x is not on the current one."""
  import torch
  if x.device.index == torch.cuda.current_device():
    return fn(*args, torch.cuda.current_stream().cuda_stream)
  with torch.cuda.device(x.device):
    return fn(*args, torch.cuda.current_stream().cuda_stream)


def load(source: str) -> ctypes.CDLL:
  """The loaded library of `csrc/<source>`, built on first use."""
  lib = _LOADED.get(source)
  if lib is None:
    lib = ctypes.CDLL(str(build(source)))
    _LOADED[source] = lib
  return lib
