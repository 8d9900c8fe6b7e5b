"""Carry JAX-package weights over to the port.

The port's state_dict keys are the reference torch INDM's, which
`indm_tpu/models/convert.py:ncsnpp_params_from_torch` and
`indm_tpu/flows/convert.py` read. The functions here go the other way:
from the JAX parameter pytrees (as numpy arrays) to the port's state_dict,
for the score net, the flow and the FID's InceptionV3.
Conv kernels go HWIO -> OIHW, dense kernels [in, out] -> [out, in].
Each walks the port's module tree, built on the meta device, so that
the walk and the model cannot disagree; each score net records the JAX
package's name of each module it holds (`jax_names`).
"""

from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn

from indm_torch.flows import lipschitz as lip
from indm_torch.flows import wolf, wolf_extras, wolf_glow, wolf_macow
from indm_torch.flows.flow_model import FlowModel
from indm_torch.flows.resflow import ActNorm2d, IResBlock
from indm_torch.models import layers, registry
from indm_torch.models import normalization as norm_lib


def _t(a) -> torch.Tensor:
  return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(p):
  return {"weight": _t(np.transpose(p["kernel"], (3, 2, 0, 1))),
          "bias": _t(p["bias"])}


def _dense(p):
  return {"weight": _t(np.transpose(p["kernel"])), "bias": _t(p["bias"])}


def _score_module(mod, p):
  """Port module + its JAX sub-dict -> {param name: tensor}. A res block's
  `Dense_0` that the JAX net lacks (an unconditional net: the reference
  keeps the projection, unused) is zero."""
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
    if key not in p and name == "Dense_0":
      out.update({f"{name}.{k}": torch.zeros_like(v, device="cpu")
                  for k, v in child.state_dict().items()})
      continue
    for k, v in _score_module(child, p[key]).items():
      out[f"{name}.{k}"] = v
  return out


def _plus_one(p, key):
  return _t(np.asarray(p[key], np.float32) + np.float32(1.0))


def _refinenet_module(mod, p, stats):
  """A module of the RefineNet nets (`indm_torch.models.ncsnv2`,
  `normalization`) + its JAX sub-dicts of params and batch_stats -> {param
  name: tensor}. The gains the JAX package keeps as offsets from 1 get the
  1 back."""
  if isinstance(mod, nn.Conv2d):
    out = {"weight": _t(np.transpose(p["kernel"], (3, 2, 0, 1)))}
    if mod.bias is not None:
      out["bias"] = _t(p["bias"])
    return out
  if isinstance(mod, layers.GroupNorm):
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}
  if isinstance(mod, (norm_lib.InstanceNorm2dPlus, norm_lib.VarianceNorm2d)):
    out = {"alpha": _plus_one(p, "alpha")}
    if isinstance(mod, norm_lib.InstanceNorm2dPlus):
      out["gamma"] = _plus_one(p, "gamma")
    if mod.beta is not None:
      out["beta"] = _t(p["beta"])
    return out
  if isinstance(mod, norm_lib._Conditional):
    e = np.array(p["Embed_0"]["embedding"], np.float32)
    if isinstance(mod, norm_lib.ConditionalInstanceNorm2dPlus):
      e[:, :2 * mod.num_features] += np.float32(1.0)
    out = {"embed.weight": _t(e)}
    if isinstance(mod, norm_lib.ConditionalBatchNorm2d):
      bs = stats["BatchNorm_0"]
      out.update({"bn.running_mean": _t(bs["mean"]),
                  "bn.running_var": _t(bs["var"]),
                  "bn.num_batches_tracked": torch.zeros((),
                                                        dtype=torch.long)})
    return out
  out = {}
  for path, name in getattr(mod, "jax_names", {}).items():
    sub = (stats or {}).get(name)
    for k, v in _refinenet_module(mod.get_submodule(path), p.get(name, {}),
                                  sub).items():
      out[f"{path}.{k}"] = v
  return out


def score_state_dict_from_jax(params_np, config, buffers_np=None,
                              batch_stats_np=None) -> dict:
  """JAX score-net params (numpy pytree) -> the port's state_dict of the
  net `model.name`. NCSN++ (and VDM, whose JAX tree nests it as
  `backbone`) and DDPM walk `all_modules` by their `jax_names`; the VE
  net's Fourier projection takes its fixed W from the flax `buffers`
  collection, `buffers_np`. The RefineNet nets walk each module's
  `jax_names` (NCSNv2's JAX tree nests the body as `_NCSNv2Base_0`), the
  conditional BatchNorm's running statistics from `batch_stats_np`."""
  name = config.model.name
  model = registry.model_classes()[name](config, device="meta")
  if name not in ("ncsnpp", "vdm", "ddpm"):
    if name != "ncsn":
      params_np = params_np["_NCSNv2Base_0"]
      batch_stats_np = (batch_stats_np or {}).get("_NCSNv2Base_0")
    return _refinenet_module(model, params_np, batch_stats_np)
  if name == "vdm":
    params_np = params_np["backbone"]
    buffers_np = (buffers_np or {}).get("backbone")
  sd = {}
  for i, (mod, jname) in enumerate(zip(model.all_modules, model.jax_names)):
    if isinstance(mod, layers.GaussianFourierProjection):
      sd[f"all_modules.{i}.W"] = _t(buffers_np[jname]["W"])
      continue
    if not any(True for _ in mod.parameters()):
      continue
    if jname.startswith("Conv_") and not isinstance(mod, nn.Conv2d):
      # DDPM's resampling: a bare conv of the JAX net, the reference's
      # module around its `Conv_0`
      got = {f"Conv_0.{k}": v for k, v in _conv(params_np[jname]).items()}
    else:
      got = _score_module(mod, params_np[jname])
    for k, v in got.items():
      sd[f"all_modules.{i}.{k}"] = v
  return sd


def vdm_aux_state_dict_from_jax(params_np) -> dict:
  """The JAX VDM auxiliary params (`indm_tpu/run_lib.py:load_vdm_aux`:
  `gamma` and the schedule's three Dense layers) -> `VDMAux`'s
  state_dict."""
  sd = {"gamma": _t(params_np["gamma"])}
  for name, p in params_np["schedule"].items():
    sd.update({f"schedule.{name}.{k}": v for k, v in _dense(p).items()})
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


def _gn(p):
  return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _encoder(enc, p, stats):
  """The JAX GlobalResNetEncoderBN or GN (params, batch_stats) -> the
  port's `discriminator.encoder` entries (the reference's names)."""
  out = {}
  gn = isinstance(enc.net.resnet0.main[0], wolf.ResNetBlockGN)
  cls, norm = ("ResNetBlockGN", "GroupNorm") if gn else ("ResNetBlockBN",
                                                         "BatchNorm")
  n1, n2 = enc.net.resnet0.main[0].norm_names
  for level in range(len(enc.net) - 1):
    for j in range(2):
      name = f"{cls}_{2 * level + j}"
      bp, bs = p[name], (stats or {}).get(name, {})
      pfx = f"net.resnet{level}.main.{j}"
      pairs = [("conv1", n1, "0"), ("conv2", n2, "1")]
      if "Conv_2" in bp:
        pairs.append(("downsample.0", "downsample.1", "2"))
      for conv, bn, k in pairs:
        out[f"{pfx}.{conv}.weight"] = _t(np.transpose(bp[f"Conv_{k}"]["kernel"],
                                                      (3, 2, 0, 1)))
        nv = (_gn(bp[f"{norm}_{k}"]) if gn else
              _bn(bp[f"{norm}_{k}"], bs.get(f"{norm}_{k}")))
        for key, v in nv.items():
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


def _resflow(resflow, layers_np, prefix):
  """The JAX residual flow's per-scale layer lists -> the port's entries
  under `prefix`: a scale's scanned stack (stacked parameters) is
  unstacked into one module per block, an actnorm's `log_scale` is the
  port's `weight`."""
  sd = {}
  for s, t in enumerate(resflow.transforms):
    jax_layers = iter(layers_np[s])
    stack, k = None, 0
    for i, layer in enumerate(t.chain):
      if isinstance(layer, IResBlock) and layer.in_stack:
        if stack is None:
          stack, k = next(jax_layers), 0
        p, k = _take(stack, k), k + 1
      else:
        stack, p = None, next(jax_layers)
      pfx = f"{prefix}transforms.{s}.chain.{i}"
      if isinstance(layer, IResBlock):
        entries = _iresblock(layer, p)
      elif isinstance(layer, ActNorm2d):
        entries = {"weight": _t(p["log_scale"]), "bias": _t(p["bias"])}
      else:
        entries = {}
      for key, v in entries.items():
        sd[f"{pfx}.{key}"] = v
  return sd


def _oihw(kernel):
  return _t(np.transpose(kernel, (3, 2, 0, 1)))


def _wn_conv(p):
  return {"conv.weight_v": _oihw(p["v"]),
          "conv.weight_g": _t(np.reshape(p["g"], (-1, 1, 1, 1))),
          "conv.bias": _t(p["b"])}


def wolf_module_state_dict_from_jax(mod, p) -> dict:
  """A Glow or MaCow module of the port and its flax sub-dict ->
  {param name: tensor}; flax names lists of submodules `name_i`."""
  if isinstance(mod, wolf_glow.ActNorm2dFlow):
    return {"log_scale": _t(p["log_scale"]), "bias": _t(p["bias"])}
  if isinstance(mod, wolf_glow.Conv1x1Flow):
    return {"weight": _t(p["w"])}
  if isinstance(mod, wolf_glow.Conv2dWeightNorm):
    return _wn_conv(p)
  if isinstance(mod, wolf_glow.GlobalLinearCondNet):
    return {f"linear.{k}": v for k, v in _dense(p["Dense_0"]).items()}
  if isinstance(mod, wolf_glow.LocalLinearCondNet):
    return {f"conv.{k}": v for k, v in _conv(p["Conv_0"]).items()}
  if isinstance(mod, wolf_macow.ShiftedConv2d):
    return {"weight": _oihw(p["Conv_0"]["kernel"])}
  if isinstance(mod, wolf_glow.NICEConvBlock):
    out = {"conv1.weight": _oihw(p["Conv_0"]["kernel"]),
           "conv2.weight": _oihw(p["Conv_1"]["kernel"])}
    out.update({f"conv3.{k}": v
                for k, v in _wn_conv(p["Conv2dWeightNorm_0"]).items()})
    for i, norm in enumerate((mod.norm1, mod.norm2)):
      if isinstance(norm, wolf.BatchNorm2d):
        nv = _bn(p[f"BatchNorm_{i}"], None)
      elif norm is not None:
        nv = _gn(p[f"GroupNorm_{i}"])
      else:
        continue
      out.update({f"norm{i + 1}.{k}": v for k, v in nv.items()})
    return out
  if isinstance(mod, wolf_glow.MultiScaleFlow):
    children = {}
    for i, block in enumerate(mod.blocks):
      if isinstance(block, wolf_glow._External):
        for j, step in enumerate(block.steps):
          children[f"blocks.{i}.steps.{j}"] = (step, p[f"blocks__{i}_{j}"])
        continue
      for l, layer in enumerate(block.layers):
        for j, step in enumerate(layer):
          children[f"blocks.{i}.layers.{l}.{j}"] = (
              step, p[f"blocks__{i}_0_{l}_{j}"])
      for l, prior in enumerate(block.priors):
        children[f"blocks.{i}.priors.{l}"] = (prior, p[f"blocks__{i}_1_{l}"])
  else:
    children = {}
    for name, child in mod.named_children():
      if isinstance(child, nn.ModuleList):
        for k, c in enumerate(child):
          children[f"{name}.{k}"] = (c, p[f"{name}_{k}"])
      elif name in p:
        children[name] = (child, p[name])
  out = {}
  for name, (child, cp) in children.items():
    for k, v in wolf_module_state_dict_from_jax(child, cp).items():
      out[f"{name}.{k}"] = v
  return out


def _categorical(p):
  out = {"embed.weight": _t(p["embed"]["embedding"])}
  for i, name in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
    out.update({f"net.{i}.{k}": v for k, v in _dense(p[name]).items()})
  return out


def flow_state_dict_from_jax(params_np, config, batch_stats=None) -> dict:
  """JAX FlowModel params (numpy; {'resflow': [...]} or {'gen': ...}, and
  'disc' for a wolf with a discriminator that has parameters) and its
  `batch_stats` buffers (None: the initial statistics) -> the port's
  FlowModel state_dict: the residual flow (bare, or the wolf's generator,
  its actnorms too) or the Glow or MaCow generator; the Gaussian
  discriminator's encoder (BatchNorm or GroupNorm), head and flow prior, or
  the categorical one's embedding and dense layers. A tree of gradients
  converts the same way."""
  model = FlowModel(config, device="meta")
  if model.kind == "resflow":
    return _resflow(model.resflow, params_np["resflow"], "")
  if model.resflow is not None:
    sd = _resflow(model.resflow, params_np["resflow"], "generator.flow.")
  else:
    gen = wolf_module_state_dict_from_jax(model.gen_module, params_np["gen"])
    sd = {f"generator.flow.{k}": v for k, v in gen.items()}
  disc = model.discriminator
  if isinstance(disc, wolf_extras.CategoricalDiscriminator):
    sd.update({f"discriminator.{k}": v
               for k, v in _categorical(params_np["disc"]).items()})
  if not isinstance(disc, wolf.GaussianDiscriminator):
    return sd
  stats = (batch_stats or {}).get("encoder")
  for k, v in _encoder(disc.encoder, params_np["disc"]["encoder"],
                       stats).items():
    sd[f"discriminator.encoder.{k}"] = v
  out_planes = disc.encoder.net.top.weight.shape[0]
  for k, v in _fc(params_np["disc"]["fc"], out_planes).items():
    sd[f"discriminator.fc.{k}"] = v
  if disc.prior_type == "flow":
    prior = params_np["disc"]["prior"]
    for i in range(len(disc.prior.flow.steps)):
      for k, v in _prior_step(prior[f"steps_{i}"]).items():
        sd[f"discriminator.prior.flow.steps.{i}.{k}"] = v
  return sd


def inception_state_from_flax(variables_np) -> dict:
  """The JAX package's InceptionV3 variables (`{"params": ...,
  "batch_stats": ...}` as numpy arrays, flax names: `Mixed_5b/branch1x1/
  Conv_0/kernel`, `.../BatchNorm_0/{scale, bias, mean, var}`, `fc/kernel`)
  -> `indm_torch.metrics.inception.InceptionV3FID`'s state_dict."""
  from indm_torch.metrics import inception
  params, stats = variables_np["params"], variables_np["batch_stats"]
  out = {}
  for path in inception.fid_conv_modules():
    p, s = params, stats
    for part in path.split("."):
      p, s = p[part], s[part]
    out[f"{path}.conv.weight"] = _t(np.transpose(p["Conv_0"]["kernel"],
                                                 (3, 2, 0, 1)))
    out[f"{path}.bn.weight"] = _t(p["BatchNorm_0"]["scale"])
    out[f"{path}.bn.bias"] = _t(p["BatchNorm_0"]["bias"])
    out[f"{path}.bn.running_mean"] = _t(s["BatchNorm_0"]["mean"])
    out[f"{path}.bn.running_var"] = _t(s["BatchNorm_0"]["var"])
  fc = _dense(params["fc"])
  out["fc.weight"], out["fc.bias"] = fc["weight"], fc["bias"]
  return out
