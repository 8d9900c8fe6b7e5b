#!/usr/bin/env python3
"""Drive the PyTorch port of INDM on one CUDA card and check it.

  python3 chip_smoke.py

Run from the root of a checkout; it needs one card and nothing but the
checkout. Phases (any failure exits non-zero before the result lines):

1. print the card's name and power limit; build the kernels from
   `indm_torch/csrc/` (`build/kernels/`).
2. hold the GroupNorm(+swish) kernel against its plain version at every
   distinct (shape, activation) that the full-width NCSN++ launches at
   batch 64, in float32 and bfloat16, and time it beside its bound, the
   plain version and `torch.nn.functional.group_norm` (+ `silu`).
3. one full-width score evaluation at batch 64, through the kernel and
   through the plain version, compared; then one more under
   `torch.profiler`: device time by kernel and the device's busy share.
4. one full-width ODE sampling round of `vp/CIFAR10/indm_nll` at batch 64
   (`model.fused_groupnorm=True`) through `indm_torch.sample.run`: output
   shape and finiteness, function evaluations, seconds, images/s, and the
   kernel launches of the round against 95 per score evaluation.
5. a small-input reference: at the tiny geometry of the CPU tests (which
   hold the CPU path against the JAX package), the card (through the
   kernel) against the CPU (the plain version), same weights and noise:
   the score function at several t, the flow inverse, and one ODE round.
6. a JSON line of the ported kernels and, last, `{"ok": true, ...}`.

Weights are random, drawn from the config's seed, with
`model.init_scale = 1.0`: at the VP default of 0 the last conv of each
block starts near 1e-10 and the score net is nearly a chain of skips.
TF32 is off for convolutions and matmuls (f32 numerics, as in JAX).
"""

import collections
import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch

BATCH = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
# arithmetic per element of the kernel: two sums (4), normalise (3),
# swish (about 4)
OPS_PER_ELEMENT = 11
GN_PER_SCORE_EVAL = 95     # 88 in the 44 res blocks, 6 attention, 1 output
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SCORE_RTOL = 1e-4
# the tiny geometry of tests/test_golden.py, as the CPU tests run it
SMALL = {"data.image_size": 8, "model.nf": 8, "model.num_res_blocks": 1,
         "model.ch_mult": (1, 1), "model.attn_resolutions": (4,),
         "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
         "eval.rtol": 1e-3, "eval.atol": 1e-3}
SMALL_BATCH = 4
# card vs CPU on the small input. float32 convs and sums in another order:
# 1e-5 relative. At t = 1e-3 the std of the VP marginal is
# sqrt(1 - exp(-1.1e-4)) in float32 (as the JAX package computes it), which
# keeps about 3 digits, and the card's expf may differ from the CPU's by an
# ulp: 1e-3 there. The ODE round: two adaptive solves at rtol = 1e-3 whose
# step sequences may differ on that account; 1e-2 of the largest value.
SMALL_RTOL = 1e-5
SMALL_RTOL_T_EPS = 1e-3
SMALL_ROUND_RTOL = 1e-2
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
  print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def smoke_config():
  from indm_torch.configs import get_config
  cfg = get_config("vp/CIFAR10/indm_nll")
  cfg.model.fused_groupnorm = True
  cfg.model.init_scale = 1.0
  cfg.sampling.batch_size = BATCH
  return cfg


def phase_card_and_build():
  smi = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip()
  log(smi)
  from indm_torch.ops import build
  t0 = time.perf_counter()
  path = build.build("group_norm.cu")
  log(f"built {os.path.relpath(path, REPO)} in "
      f"{time.perf_counter() - t0:.3f} s")
  return smi


def group_norm_shapes(model, x, t):
  """(shape, groups, act) -> launches in one forward, from hooks."""
  from indm_torch.models.layers import GroupNorm
  seen = collections.Counter()
  hooks = [m.register_forward_pre_hook(
      lambda mod, args: seen.update([(tuple(args[0].shape), mod.num_groups,
                                      mod.act)]))
           for m in model.modules() if isinstance(m, GroupNorm)]
  try:
    with torch.no_grad():
      model(x, t)
    torch.cuda.synchronize()
  finally:
    for h in hooks:
      h.remove()
  return seen


def phase_group_norm(model, x, t):
  import torch.nn.functional as F
  from indm_torch.ops import group_norm as gn
  shapes = group_norm_shapes(model, x, t)
  n_calls = sum(shapes.values())
  log(f"GroupNorm calls per score evaluation: {n_calls} "
      f"({len(shapes)} distinct shape/act)")
  if n_calls != GN_PER_SCORE_EVAL:
    raise AssertionError(f"expected {GN_PER_SCORE_EVAL} GroupNorm calls, "
                         f"got {n_calls}")
  gen = torch.Generator(device="cuda").manual_seed(0)
  per_eval = collections.defaultdict(float)
  max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
  for (shape, groups, act), count in sorted(shapes.items()):
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
      xs = (0.5 + 1.5 * torch.randn(shape, device="cuda",
                                    generator=gen)).to(dtype)
      y = gn.group_norm_act(xs, scale, bias, groups, act=act)
      y_plain = gn.group_norm_act_plain(xs, scale, bias, groups, act=act)
      torch.cuda.synchronize()
      err = (y.float() - y_plain.float()).abs().max().item()
      tol = TOL[dtype]
      bad = ((y.float() - y_plain.float()).abs()
             > tol + tol * y_plain.float().abs()).any().item()
      if bad or not math.isfinite(err):
        raise AssertionError(f"group_norm {shape} {dtype} {act}: max abs "
                             f"err {err} over tolerance {tol}")
      max_err[dtype] = max(max_err[dtype], err)

      def library():
        out = F.group_norm(xs, groups, scale.to(dtype), bias.to(dtype), 1e-6)
        return F.silu(out) if act == "swish" else out

      ms = cuda_ms(lambda: gn.group_norm_act(xs, scale, bias, groups,
                                             act=act))
      plain_ms = cuda_ms(lambda: gn.group_norm_act_plain(xs, scale, bias,
                                                         groups, act=act))
      library_ms = cuda_ms(library)
      nbytes = 2 * xs.numel() * xs.element_size()
      bound_ms = max(nbytes / HBM_BYTES_PER_S,
                     OPS_PER_ELEMENT * xs.numel() / F32_FLOPS) * 1e3
      dname = str(dtype).replace("torch.", "")
      log(f"group_norm {list(shape)} groups={groups} act={act} {dname} "
          f"x{count}/eval: max_abs_err={err:.3e} ms={ms:.5f} "
          f"bound_ms={bound_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={library_ms:.5f}")
      if dtype == torch.float32:
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("bound_ms", bound_ms)):
          per_eval[key] += count * v
  log(f"group_norm per score evaluation (float32, {n_calls} launches): "
      + " ".join(f"{k}={v:.5f}" for k, v in per_eval.items()))
  log(f"group_norm max_abs_err float32={max_err[torch.float32]:.3e} "
      f"bfloat16={max_err[torch.bfloat16]:.3e}")
  return dict(per_eval), max_err[torch.float32]


@contextlib.contextmanager
def plain_group_norm():
  """Route the score net's GroupNorm through the plain version."""
  from indm_torch.ops import group_norm as gn
  kernel = gn.group_norm_act
  gn.group_norm_act = gn.group_norm_act_plain
  try:
    yield
  finally:
    gn.group_norm_act = kernel


def phase_score(cfg, model, x, t):
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import get_score_fn
  from indm_torch.ops import group_norm as gn
  score_fn = get_score_fn(cfg, sde_lib.get_sde(cfg), model)
  gn.reset_launches()
  s_kernel = score_fn(x, t)
  torch.cuda.synchronize()
  launches = gn.launches
  with plain_group_norm():
    s_plain = score_fn(x, t)
    torch.cuda.synchronize()
    plain_eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  if gn.launches != launches:
    raise AssertionError("the plain run launched the kernel")
  if launches != GN_PER_SCORE_EVAL:
    raise AssertionError(f"score evaluation launched {launches} kernels")
  kernel_eval_ms = cuda_ms(lambda: score_fn(x, t), iters=3, warmup=1)
  ref = s_plain.abs().max().item()
  rel = (s_kernel - s_plain).abs().max().item() / ref
  log(f"score eval [{BATCH},3,32,32]: kernel vs plain max rel err "
      f"{rel:.3e} (limit {SCORE_RTOL}), max |score| {ref:.4g}; "
      f"ms kernel={kernel_eval_ms:.3f} plain={plain_eval_ms:.3f}")
  if not (torch.isfinite(s_kernel).all() and rel <= SCORE_RTOL):
    raise AssertionError("score evaluation through the kernel disagrees")
  profile_score_eval(score_fn, x, t)
  return kernel_eval_ms


def profile_score_eval(score_fn, x, t, top=8):
  """Device time of one score evaluation by kernel, and the share of the
  host's wall time (profiler on) in which the device was busy."""
  from torch.profiler import ProfilerActivity, profile
  score_fn(x, t)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    score_fn(x, t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  if not kernels:
    log("profile: the profiler saw no device time")
    return
  gn_ms = sum(e.self_device_time_total for e in kernels
              if "group_norm_fwd_kernel" in e.key) / 1e3
  log(f"profile of one score eval: device busy {busy_ms:.3f} ms of "
      f"{wall_ms:.3f} ms wall ({busy_ms / wall_ms:.4f}); group_norm kernel "
      f"{gn_ms:.3f} ms ({gn_ms / busy_ms:.4f} of device time)")
  for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
    log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
        f"{e.key[:100]}")


def phase_sample(cfg, workdir):
  from indm_torch import sample
  from indm_torch.flows.flow_model import create_flow_model, flow_forward
  from indm_torch.ops import group_norm as gn
  gn.reset_launches()
  (res,) = sample.run(cfg, workdir, batch=BATCH, rounds=1, device="cuda",
                      log=log)
  launches = gn.launches
  nfe = res["nfe"]
  expected = GN_PER_SCORE_EVAL * (nfe + 1)  # + the denoise step
  log(f"sample round: nfe={nfe} score evals={nfe + 1} seconds="
      f"{res['seconds']:.3f} images/s={res['images_per_s']:.3f} "
      f"group_norm launches={launches} (expected {expected})")
  if launches != expected or launches == 0:
    raise AssertionError("kernel launches do not match the score "
                         "evaluations of the round")
  for name in ("before", "after"):
    img = res[name]
    if tuple(img.shape) != (BATCH, 32, 32, 3):
      raise AssertionError(f"{name}: shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
      raise AssertionError(f"{name}: non-finite values")
    inside = ((img >= 0) & (img <= 1)).float().mean().item()
    log(f"{name} flow: min={img.min().item():.4g} max={img.max().item():.4g}"
        f" share in [0,1]={inside:.4f}")
  import numpy as np
  with np.load(res["paths"]["after"]) as z:
    if z["samples"].shape != (BATCH, 32, 32, 3) or z["samples"].dtype != \
        np.uint8:
      raise AssertionError("the written round has the wrong layout")

  # the flow inverse alone, on the round's own weights and a fresh latent
  flow = create_flow_model(cfg, seed=cfg.seed + 1, device="cuda")
  z = torch.randn(BATCH, 3, 32, 32, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(1))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  flow_forward(cfg, flow, z, reverse=True)
  torch.cuda.synchronize()
  steps = flow.resflow.last_inverse_steps
  log(f"flow inverse alone: seconds={time.perf_counter() - t0:.3f} "
      f"fixed-point steps per block={steps} (total {sum(steps)})")
  return res, launches


def phase_small_reference(cfg):
  from indm_torch import run_lib
  from indm_torch.flows.flow_model import flow_forward
  from indm_torch.models.registry import get_score_fn
  small = copy.deepcopy(cfg)
  for name, value in SMALL.items():
    *path, leaf = name.split(".")
    node = small
    for part in path:
      node = node[part]
    node[leaf] = value
  gen = torch.Generator().manual_seed(3)
  size = small.data.image_size
  x = torch.randn(SMALL_BATCH, 3, size, size, generator=gen)
  sampling = {d: run_lib.build_sampling(small, SMALL_BATCH, device=d, seed=7)
              for d in ("cpu", "cuda")}
  eps = torch.randn(SMALL_BATCH, sampling["cpu"].flow_model.discriminator.dim,
                    generator=gen)

  def rel(got, ref):
    return ((got.float().cpu() - ref).abs().max() / ref.abs().max()).item()

  def check(what, err, limit):
    log(f"small reference {what}: card vs cpu max rel err {err:.3e} "
        f"(limit {limit})")
    if not err <= limit:
      raise AssertionError(f"{what} on the card disagrees with the CPU")

  fns = {d: get_score_fn(small, s.sde, s.score_model)
         for d, s in sampling.items()}
  for t in (1e-3, 0.1, 0.5, 1.0):
    vt = torch.full((SMALL_BATCH,), t)
    check(f"score t={t}", rel(fns["cuda"](x.cuda(), vt.cuda()),
                              fns["cpu"](x, vt)),
          SMALL_RTOL_T_EPS if t < 0.1 else SMALL_RTOL)
  inv = {d: flow_forward(small, s.flow_model, x.to(d), reverse=True,
                         prior_eps=eps.to(d))[0]
         for d, s in sampling.items()}
  check("flow inverse", rel(inv["cuda"], inv["cpu"]), SMALL_RTOL)
  rounds = {d: run_lib.sample_round(small, s, prior_noise=x.to(d),
                                    prior_eps=eps.to(d))
            for d, s in sampling.items()}
  after, nfe = {d: r[1] for d, r in rounds.items()}, {
      d: r[2] for d, r in rounds.items()}
  log(f"small reference round: nfe cuda={nfe['cuda']} cpu={nfe['cpu']}")
  if not torch.isfinite(after["cuda"]).all():
    raise AssertionError("the small round on the card is not finite")
  check("ODE round", rel(after["cuda"], after["cpu"].float()),
        SMALL_ROUND_RTOL)


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA card; nothing was run", file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  try:
    import indm_torch  # noqa: F401
  except ImportError:
    print("chip_smoke: run it from the root of a checkout (indm_torch is "
          "missing)", file=sys.stderr)
    return 2
  from indm_torch import run_lib
  try:
    smi = phase_card_and_build()
    cfg = smoke_config()
    run_lib.set_f32_numerics()
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    from indm_torch.models.registry import create_model
    model = create_model(cfg, seed=cfg.seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 3, 32, 32, device="cuda", generator=gen)
    t = torch.full((BATCH,), 0.3, device="cuda")
    per_eval, max_err = phase_group_norm(model, x, t * 999)
    phase_score(cfg, model, x, t)
    del model
    torch.cuda.empty_cache()
    res, launches = phase_sample(cfg, os.path.join(REPO, "build",
                                                   "chip_smoke"))
    phase_small_reference(cfg)
  except Exception:  # any phase failure ends the run without a result
    traceback.print_exc()
    return 1
  kernels = [{
      "name": "group_norm_fwd", "route": "cuda",
      "source": "indm_torch/csrc/group_norm.cu",
      "replaces": "indm_tpu/ops/group_norm_pallas.py:151",
      "launches": launches, "max_abs_err": max_err,
      "ms": per_eval["ms"], "plain_ms": per_eval["plain_ms"],
      "bound_ms": per_eval["bound_ms"], "bound_by": "bytes",
      "library_ms": per_eval["library_ms"],
      "per": f"the {GN_PER_SCORE_EVAL} float32 launches of one score "
             f"evaluation at batch {BATCH}"}]
  log(json.dumps({"kernels": kernels,
                  "round": {"nfe": res["nfe"], "seconds": res["seconds"],
                            "images_per_s": res["images_per_s"]}}))
  log(smi)
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
