"""Time the net's kernels of another checkout with this one's chip_smoke.py.

  python3 indm_torch/scripts/ab_kernels.py PATH
      [--only {chain,score_net,routes}] [--draws N] [--dump DIR]

PATH is the root of a checkout of this repository (an older commit
unpacked with `git archive`, or `.` for this one). Its `indm_torch`
package, built from its own sources, is timed by this checkout's
chip_smoke.py measurements, so that two commits are compared by the same
code on the same card in one call (run PATH, ., ., PATH).
`--only score_net` runs the score net's kernels alone: kernels 1 and 9 at
the full-width VP and VE nets' call shapes at batch 64 (phases 2 and 5b:
`ms`, `graph_ms` and `host_ms` a shape and the sums an evaluation, the
library call by events and in a graph), kernel 2 at kernel 1's shapes at
batch 128 (phase 7, the same times a shape and a training step), one VP
and one VE score evaluation (events, then one profiled: the kernels'
device ms and the busy share), and a digest of each kernel's output at
each shape: kernels 1 and 2 in float32 and bfloat16, kernel 9 in
float32.
`--only chain` runs the flow's kernels alone: phase 6e (the
bfloat16 GEMM at its six products), phase 6c's chain shapes (conv_in
at both scales in float32 and bfloat16, narrow_out in float32), phase
6g's route comparison (kernel 8 against chain_mats and kernel 7 in
bfloat16, the margin of each of N seeded eps draws at both scales,
pre-activated and not; by default CHAIN8_DRAWS, the smoke's own draws),
and phases 6 and 6b's float32 chains (kernels 7 and 8 at both scales,
pre-activated, n = 2 and 6, beside the same series through F.conv2d),
with a digest of each chain's output in float32 and bfloat16, so that
two checkouts' bits can be compared. By default both groups run.
`--only routes` runs phase 6g's route comparison alone. `--dump DIR`
writes, for each case with a draw whose largest-element margin is under
1, its inputs to
`DIR/route_draws_scale{S}_preact{P}.pt`: the block's state_dict, x, h,
the eps of every such draw and of draw 0 (a control), their indices,
and those draws' largest-element margins, so that other implementations
of the two routes can be run on the same inputs
(`tests/test_torch_route_margins.py`).
Run as a file, not with -m, so that the
package imported is PATH's. Needs a card; prints chip_smoke's lines and
one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def chain8_margins(cs, draws, dump=None):
  """{"scale S preact P": {"rms" and "largest": {n: [margin of each
  draw]}}}: chip_smoke's
  chain8_route_margins on its chain8_route_inputs, from one generator
  seeded 12 as phase 6g draws them (with `draws` = CHAIN8_DRAWS, the same
  inputs), and the number of draws under 1 (the rms margin under 1 fails
  phase 6g; the largest element's is logged). With `dump` a directory,
  the inputs of each case with a largest-element margin under 1 are
  written there (the module's docstring)."""
  import torch
  gen = torch.Generator(device="cuda").manual_seed(12)
  out = {}
  for scale, (c, hw) in enumerate(cs.CHAIN_SCALES):
    for preact in (False, True):
      block, x, h, eps = cs.chain8_route_inputs(c, hw, preact, gen, draws)
      m, largest = cs.chain8_route_margins(block, x, h, eps, preact)
      for name, ms_by_n in (("rms", m), ("largest-element", largest)):
        cs.log(f"chain8 route {name} margins scale {scale} "
               f"preact={preact}, {draws} draws: "
               + "; ".join(f"n={n} smallest {min(ms):.4f}, under 1: "
                           f"{sum(not v >= 1 for v in ms)}"
                           for n, ms in ms_by_n.items())
               + "; n=6 each: " + " ".join(f"{v:.4f}" for v in ms_by_n[6]))
      out[f"scale {scale} preact {preact}"] = {"rms": m, "largest": largest}
      under = sorted({i for ms in largest.values()
                      for i, v in enumerate(ms) if not v >= 1})
      if dump and under:
        keep = sorted({0, *under})
        os.makedirs(dump, exist_ok=True)
        torch.save({"c": c, "hw": hw, "preact": preact, "draws": keep,
                    "state_dict": {k: v.cpu() for k, v in
                                   block.state_dict().items()},
                    "x": x.cpu(), "h": h.cpu(),
                    "eps": torch.stack([eps[i] for i in keep]).cpu(),
                    "margins": {n: [ms[i] for i in keep]
                                for n, ms in largest.items()}},
                   os.path.join(dump, f"route_draws_scale{scale}_preact"
                                f"{int(preact)}.pt"))
      del block, x, h, eps
  return out


def _digest(t):
  """The first 16 hex digits of the sha256 of a tensor's bytes."""
  import torch
  t = t.detach().contiguous()
  if t.dtype == torch.bfloat16:  # numpy has no bfloat16: hash its bits
    t = t.view(torch.int16)
  return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def chain_times(cs, ns=(2, 6), iters=10):
  """{"scale S n N": {...}}: kernel 7 (`neumann_chain`) and kernel 8
  (`fused_neumann_chain`, hp) in float32, pre-activated, at both scales
  and each n of `ns`, timed by chip_smoke's cuda_ms (`iters` calls after
  2) on its chain_inputs and fused_inputs (one generator seeded 4, as
  phase 6 seeds its own), beside the same series through F.conv2d
  (chain_library; PyTorch, the same on every checkout); and the digest of
  each kernel's output in float32 and, on the same values cast, in
  bfloat16 (the bfloat16 modes must not change between checkouts)."""
  import torch
  from indm_torch.flows.resflow import OFFSET_TRAIN, RCDF_TRAIN
  from indm_torch.ops import neumann
  bf = torch.bfloat16
  gen = torch.Generator(device="cuda").manual_seed(4)
  out = {}
  for scale, (c, hw) in enumerate(cs.CHAIN_SCALES):
    vareps, dacts, ws = cs.chain_inputs(cs.TRAIN_BATCH, c, hw, True, gen)
    d = cs.fused_inputs(cs.TRAIN_BATCH, c, hw, gen)
    w0, w1, w2 = d["ws"]
    mats = ((w0, w1[:, :, 0, 0]), tuple(d["bs"][:2]),
            [neumann.transpose_conv_weight(w).contiguous()
             for w in (w2, w1, w0)])
    k7 = (vareps, dacts, ws)
    k8 = (d["x"], d["eps"], *mats, d["hp"])
    k7_16 = (vareps.to(bf), [a.to(bf) for a in dacts],
             [w.to(bf).contiguous() for w in ws])
    k8_16 = (d["x"].to(bf), d["eps"].to(bf), tuple(m.to(bf) for m in mats[0]),
             tuple(b.to(bf) for b in mats[1]), [w.to(bf) for w in mats[2]],
             d["hp"].to(bf))
    for n in ns:
      tail = (n, OFFSET_TRAIN, RCDF_TRAIN)
      row = {
          "k7_ms": cs.cuda_ms(lambda: neumann.neumann_chain(*k7, *tail),
                              iters, 2),
          "k8_ms": cs.cuda_ms(
              lambda: neumann.fused_neumann_chain(*k8, *tail, True), iters,
              2),
          "library_ms": cs.cuda_ms(
              lambda: cs.chain_library(vareps, dacts, ws, n), iters, 2),
          "k7_f32": _digest(neumann.neumann_chain(*k7, *tail)),
          "k8_f32": _digest(neumann.fused_neumann_chain(*k8, *tail, True)),
          "k7_bf16": _digest(neumann.neumann_chain(*k7_16, *tail)),
          "k8_bf16": _digest(neumann.fused_neumann_chain(*k8_16, *tail,
                                                         True))}
      cs.log(f"float32 chains scale {scale} [{cs.TRAIN_BATCH},{c},{hw},{hw}]"
             f" preact=True n={n}: "
             + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in row.items()))
      out[f"scale {scale} n {n}"] = row
    del vareps, dacts, ws, d, mats, k7, k8, k7_16, k8_16
    torch.cuda.empty_cache()
  return out


def score_net_times(cs):
  """Kernels 1, 2 and 9 through chip_smoke's phases 2, 3, 7, 5b and 5c on
  the full-width nets (the same seeds as the smoke), and the digest of
  each kernel's output at each call shape on seeded inputs."""
  import torch
  from indm_torch import sde as sde_lib
  from indm_torch.models.registry import create_model
  from indm_torch.ops import group_norm as gn
  from indm_torch.ops import upfirdn2d as fir
  cfg = cs.smoke_config()
  model = create_model(cfg, seed=cfg.seed, device="cuda")
  gen = torch.Generator(device="cuda").manual_seed(2)
  x = torch.randn(cs.BATCH, 3, 32, 32, device="cuda", generator=gen)
  t = torch.full((cs.BATCH,), 0.3, device="cuda")
  gn_per_eval, _, shapes, gn_by_shape = cs.phase_group_norm(model, x,
                                                            t * 999)
  vp_ms, vp_profile = cs.phase_score(cfg, model, x, t)
  del model
  torch.cuda.empty_cache()
  bwd_per_step, _, bwd_by_shape = cs.phase_group_norm_backward(shapes)
  gen = torch.Generator(device="cuda").manual_seed(13)
  digests = {}
  for (shape, groups, act), _ in sorted(shapes.items()):
    c = shape[1]
    scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
    bias = 0.2 * torch.randn(c, device="cuda", generator=gen)
    xs = 0.5 + 1.5 * torch.randn(shape, device="cuda", generator=gen)
    dy = torch.randn(shape, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
      digests[f"group_norm {list(shape)} {act} {dtype}"] = _digest(
          gn.group_norm_act(xs.to(dtype), scale, bias, groups, act=act))
      grads = gn.group_norm_act_backward(xs.to(dtype), dy.to(dtype), scale,
                                         bias, groups, act=act)
      digests[f"group_norm_bwd {list(shape)} {act} {dtype}"] = "/".join(
          _digest(g) for g in grads)
  torch.cuda.empty_cache()
  ve_cfg = cs.ve_config()
  fir_per_eval, _, ve_ms, ve_profile, fir_by_shape = cs.phase_ve_score(
      ve_cfg)
  model = create_model(ve_cfg, seed=ve_cfg.seed, device="cuda")
  sigma = sde_lib.get_sde(ve_cfg).marginal_prob(x, t)[1]
  for shape, up, down, pad, k, _ in cs.fir_calls(model, x, sigma):
    xs = torch.randn(shape, device="cuda", generator=gen)
    digests[f"upfirdn2d {list(shape)} up={up} down={down} pad={pad}"] = (
        _digest(fir.upfirdn2d(xs, k, up, down, pad)))
  del model
  torch.cuda.empty_cache()
  for key, d in digests.items():
    cs.log(f"digest {key}: {d}")
  return {"group_norm": {"per_eval": gn_per_eval, "by_shape": gn_by_shape},
          "group_norm_bwd": {"per_step": bwd_per_step,
                             "by_shape": bwd_by_shape},
          "upfirdn2d": {"per_eval": fir_per_eval, "by_shape": fir_by_shape},
          "vp_score_eval": {"ms": vp_ms, "profile": vp_profile},
          "ve_score_eval": {"ms": ve_ms, "profile": ve_profile},
          "digests": digests}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("path", help="the root of the checkout to time")
  ap.add_argument("--draws", type=int, default=None,
                  help="eps draws a case of phase 6g's route comparison "
                       "(default chip_smoke.CHAIN8_DRAWS)")
  ap.add_argument("--only", choices=("chain", "score_net", "routes"),
                  default=None,
                  help="run one group of kernels, or phase 6g's route "
                       "comparison alone (default: both groups)")
  ap.add_argument("--dump", default=None, metavar="DIR",
                  help="write the inputs of the route comparison's cases "
                       "with a draw under 1 under DIR")
  args = ap.parse_args(argv)
  root = os.path.abspath(args.path)
  if "indm_torch" in sys.modules or "torch" in sys.modules:
    raise RuntimeError("run ab_kernels in a fresh process: it imports the "
                       "indm_torch of the checkout given")
  sys.path.insert(0, root)
  import torch
  if not torch.cuda.is_available():
    raise RuntimeError("ab_kernels times kernels on a CUDA card; none is "
                       "available")
  spec = importlib.util.spec_from_file_location(
      "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
  cs = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(cs)
  import indm_torch
  if os.path.dirname(os.path.dirname(indm_torch.__file__)) != root:
    raise RuntimeError(f"imported {indm_torch.__file__}, not {root}'s")
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  cs.log(f"ab_kernels: {root} on {torch.cuda.get_device_name(0)}")
  out = {"checkout": root}
  if args.only in (None, "score_net"):
    out["score_net"] = score_net_times(cs)
  if args.only in (None, "chain"):
    by_shape, total, _, _ = cs.phase_gemm_bf16()
    out.update({"gemm_bf16": {"by_shape": by_shape, "total": total},
                "chain_f32": chain_times(cs),
                "chain_shapes": cs.narrow_conv_chain_shapes(),
                "chain8_margins": chain8_margins(cs, args.draws
                                                 or cs.CHAIN8_DRAWS,
                                                 args.dump)})
  if args.only == "routes":
    out["chain8_margins"] = chain8_margins(cs, args.draws or cs.CHAIN8_DRAWS,
                                           args.dump)
  cs.log(json.dumps(out, default=str))
  return 0


if __name__ == "__main__":
  sys.exit(main())
