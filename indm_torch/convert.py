"""Carry JAX-package weights over to the port.

The port's state_dict keys are the reference torch INDM's, which
`indm_tpu/models/convert.py:ncsnpp_params_from_torch` and
`indm_tpu/flows/convert.py` read. These two functions go the other way:
from the JAX parameter pytrees (as numpy arrays) to the port's state_dict.
Conv kernels go HWIO -> OIHW, dense kernels [in, out] -> [out, in].
Each walks the port's module tree, built on the meta device, so that
the walk and the model cannot disagree.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from indm_torch.flows import lipschitz as lip
from indm_torch.flows.flow_model import FlowModel
from indm_torch.flows.resflow import IResBlock
from indm_torch.models import layers
from indm_torch.models.ncsnpp import NCSNpp


def _t(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p):
  return {"weight": _t(np.transpose(p["kernel"], (3, 2, 0, 1))),
          "bias": _t(p["bias"])}


def _dense(p):
  return {"weight": _t(np.transpose(p["kernel"])), "bias": _t(p["bias"])}


def _score_module(mod, p):
  """Port module + its JAX sub-dict -> {param name: tensor}."""
  if isinstance(mod, nn.Conv2d):
    return _conv(p)
  if isinstance(mod, layers.FIRConv2d):
    return {"weight": _t(np.transpose(p["weight"], (3, 2, 0, 1))),
            "bias": _t(p["bias"])}
  if isinstance(mod, nn.Linear):
    return _dense(p)
  if isinstance(mod, layers.GroupNorm):
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}
  if isinstance(mod, layers.NIN):
    return {"W": _t(p["W"]), "b": _t(p["b"])}
  out = {}
  for name, child in mod.named_children():
    # the reference's `Conv2d_0` is flax's `FIRConv2d_0`
    key = "FIRConv2d_0" if isinstance(child, layers.FIRConv2d) else name
    for k, v in _score_module(child, p[key]).items():
      out[f"{name}.{k}"] = v
  return out


_FLAX_NAMES = {nn.Linear: "Dense", nn.Conv2d: "Conv",
               layers.Linear: "Dense", layers.Conv2d: "Conv",
               layers.GroupNorm: "GroupNorm"}


def score_state_dict_from_jax(params_np, config, buffers_np=None) -> dict:
  """JAX NCSN++ params (numpy pytree) -> the port's NCSNpp state_dict. The
  VE net's Fourier projection takes its fixed W from the flax `buffers`
  collection, `buffers_np`."""
  model = NCSNpp(config, device="meta")
  counters = collections.defaultdict(int)
  sd = {}
  for i, mod in enumerate(model.all_modules):
    cls = _FLAX_NAMES.get(type(mod), type(mod).__name__)
    name = f"{cls}_{counters[cls]}"
    counters[cls] += 1
    if isinstance(mod, layers.GaussianFourierProjection):
      sd[f"all_modules.{i}.W"] = _t(buffers_np[name]["W"])
      continue
    for k, v in _score_module(mod, params_np[name]).items():
      sd[f"all_modules.{i}.{k}"] = v
  return sd


def _take(tree, j):
  if isinstance(tree, dict):
    return {k: _take(v, j) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_take(v, j) for v in tree]
  return np.asarray(tree)[j]


def _iresblock(block: IResBlock, p):
  convs = [(i, m) for i, m in enumerate(block.nnet)
           if isinstance(m, lip.LopConv2d)]
  out = {}
  for (i, conv), cp in zip(convs, p["nnet"]):
    out[f"nnet.{i}.weight"] = _t(np.transpose(cp["w"], (3, 2, 0, 1)))
    out[f"nnet.{i}.bias"] = _t(cp["b"])
    if conv.h_net is not None:
      out[f"nnet.{i}.h_net.net.weight"] = _t(np.transpose(cp["h_w"]))
      out[f"nnet.{i}.h_net.net.bias"] = _t(cp["h_b"])
  return out


def _nice(p):
  net = p["net"]
  wn = net["DenseWeightNorm_0"]
  out = {}
  for port, flax in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
    for k, v in _dense(net[flax]).items():
      out[f"net.{port}.{k}"] = v
  out["net.fc3.linear.weight_v"] = _t(np.transpose(wn["v"]))
  out["net.fc3.linear.weight_g"] = _t(np.reshape(wn["g"], (-1, 1)))
  out["net.fc3.linear.bias"] = _t(wn["b"])
  return out


def _actnorm(p):
  return {"log_scale": _t(p["log_scale"]), "bias": _t(p["bias"])}


def _prior_step(p):
  out = {f"actnorm.{k}": v for k, v in _actnorm(p["actnorm"]).items()}
  out["linear.weight"] = _t(p["linear"]["w"])
  unit = p["unit"]
  out.update({f"unit.actnorm.{k}": v
              for k, v in _actnorm(unit["actnorm"]).items()})
  for name in ("coupling1_up", "coupling1_dn", "coupling2_up",
               "coupling2_dn"):
    out.update({f"unit.{name}.{k}": v for k, v in _nice(unit[name]).items()})
  return out


def _bn(p, stats):
  """flax BatchNorm params and batch_stats (None: the initial statistics)
  -> the port's BatchNorm2d entries."""
  c = np.asarray(p["scale"]).shape[0]
  stats = stats or {"mean": np.zeros(c), "var": np.ones(c)}
  return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
          "running_mean": _t(stats["mean"]), "running_var": _t(stats["var"]),
          "num_batches_tracked": torch.zeros((), dtype=torch.long)}


def _encoder(enc, p, stats):
  """The JAX GlobalResNetEncoderBN (params, batch_stats) -> the port's
  `discriminator.encoder` entries (the reference's names)."""
  out = {}
  for level in range(len(enc.net) - 1):
    for j in range(2):
      name = f"ResNetBlockBN_{2 * level + j}"
      bp, bs = p[name], (stats or {}).get(name, {})
      pfx = f"net.resnet{level}.main.{j}"
      pairs = [("conv1", "bn1", "0"), ("conv2", "bn2", "1")]
      if "Conv_2" in bp:
        pairs.append(("downsample.0", "downsample.1", "2"))
      for conv, bn, k in pairs:
        out[f"{pfx}.{conv}.weight"] = _t(np.transpose(bp[f"Conv_{k}"]["kernel"],
                                                      (3, 2, 0, 1)))
        for key, v in _bn(bp[f"BatchNorm_{k}"],
                          bs.get(f"BatchNorm_{k}")).items():
          out[f"{pfx}.{bn}.{key}"] = v
  for k, v in _conv(p["Conv_0"]).items():
    out[f"net.top.{k}"] = v
  return out


def _fc(p, out_planes):
  """The JAX head (input flattened NHWC) -> the port's (input flattened
  NCHW, as torch's): the input rows of v are permuted."""
  v = np.asarray(p["v"])
  hw = int(round((v.shape[0] / out_planes) ** 0.5))
  idx = np.arange(v.shape[0]).reshape(out_planes, hw, hw).transpose(
      1, 2, 0).reshape(-1)
  v_nchw = np.empty_like(v)
  v_nchw[idx] = v
  return {"linear.weight_v": _t(np.transpose(v_nchw)),
          "linear.weight_g": _t(np.reshape(p["g"], (-1, 1))),
          "linear.bias": _t(p["b"])}


def flow_state_dict_from_jax(params_np, config, batch_stats=None) -> dict:
  """JAX FlowModel params ({'resflow': [...], 'disc': {...}}, numpy) and
  its `batch_stats` buffers (None: the initial statistics) -> the port's
  FlowModel state_dict: the residual flow, the encoder, the head and the
  prior flow. The JAX stack of a scale's homogeneous blocks (one scan over
  stacked parameters) is unstacked into one module per block. A tree of
  gradients converts the same way."""
  model = FlowModel(config, device="meta")
  sd = {}
  for s, t in enumerate(model.resflow.transforms):
    jax_layers = params_np["resflow"][s]
    blocks = [m for m in t.chain if isinstance(m, IResBlock)]
    n_special = 1 if s == 0 else 0
    rest = len(blocks) - n_special
    for b, block in enumerate(blocks):
      if b < n_special:
        p = jax_layers[0]
      elif rest == 1:
        p = jax_layers[n_special]
      else:
        p = _take(jax_layers[n_special], b - n_special)
      for k, v in _iresblock(block, p).items():
        sd[f"generator.flow.transforms.{s}.chain.{b}.{k}"] = v
  disc = model.discriminator
  stats = (batch_stats or {}).get("encoder")
  for k, v in _encoder(disc.encoder, params_np["disc"]["encoder"],
                       stats).items():
    sd[f"discriminator.encoder.{k}"] = v
  out_planes = disc.encoder.net.top.weight.shape[0]
  for k, v in _fc(params_np["disc"]["fc"], out_planes).items():
    sd[f"discriminator.fc.{k}"] = v
  prior = params_np["disc"]["prior"]
  for i in range(len(model.discriminator.prior.flow.steps)):
    for k, v in _prior_step(prior[f"steps_{i}"]).items():
      sd[f"discriminator.prior.flow.steps.{i}.{k}"] = v
  return sd
