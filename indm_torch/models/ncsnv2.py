"""The NCSNv2 RefineNet score nets and the class-conditional NCSN (PyTorch,
NCHW).

Counterpart of `indm_tpu/models/ncsnv2.py`: the NCSN conv, ConvMeanPool,
the chained residual pooling, residual conv units, multi-scale fusion and
refine blocks, the pre-activation residual blocks with dilated convs or
ConvMeanPool downsampling, `NCSNv2` (`ncsnv2_64`), `NCSNv2_128`,
`NCSNv2_256`, the class-conditional `NCSN` (`ncsn`, every block normalised
by a conditional norm of the labels) and `get_network`. The output is
divided by the SMLD noise level of the integer labels, so these nets take
discrete labels (`training.continuous=False`), in both packages.

Module names are the reference's (`begin_conv`, `normalizer`, `res1`...,
`refine1`..., `end_conv`; in the blocks `normalize1`, `conv1`,
`shortcut`, `adapt_convs`, `msf`, `crp`, `output_convs`, `convs`, `norms`,
`{i}_{j}_conv`). Each module's `jax_names` maps its children to the JAX
package's names (flax's `{class}_{n}` in call order), which
`indm_torch.convert` reads.

What XLA does, the port does: convs pad as SAME (dilated too), the mean
pool sums its four phases and divides by 4, max pooling pads with -inf and
average pooling divides by the whole 5x5 window, pads included, and the
fusion's bilinear resize is `jax.image.resize`'s (half-pixel centres, the
triangle kernel widened when it shrinks: `resize_bilinear`). No kernel of
the port runs in these nets: their GroupNorm is flax's plain one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from indm_torch.models import layers
from indm_torch.models import normalization as norm_lib
from indm_torch.models.registry import get_sigmas


def ncsn_conv(in_ch, out_ch, kernel=3, bias=True, dilation=1,
              init_scale=1.0, generator=None, device=None) -> nn.Conv2d:
  """The NCSN conv (`ncsnv2.py:25-35`): SAME padding at stride 1, the
  weights U(-b, b) with b = sqrt(init_scale / fan_in) (variance scaling of
  init_scale / 3 over fan_in), a zero bias."""
  conv = nn.Conv2d(in_ch, out_ch, kernel, padding=dilation * (kernel // 2),
                   dilation=dilation, bias=bias, device=device)
  if device != "meta":
    init_scale = 1e-10 if init_scale == 0 else init_scale
    bound = math.sqrt(init_scale / (in_ch * kernel * kernel))
    with torch.no_grad():
      conv.weight.uniform_(-bound, bound, generator=generator)
      if bias:
        conv.bias.zero_()
  return conv


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
  """[n_out, n_in] weights of `jax.image.resize(..., "bilinear")` along one
  axis (its `compute_weight_mat` with the triangle kernel and antialias):
  half-pixel sample points, the kernel widened by n_in / n_out where it
  shrinks, each column normalised, samples outside the input zeroed."""
  scale = torch.tensor(n_out / n_in, dtype=torch.float32)
  inv = 1.0 / scale
  kscale = torch.clamp(inv, min=1.0)
  f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
  x = (f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
  w = torch.clamp(1.0 - x / kscale, min=0.0)
  total = w.sum(dim=0, keepdim=True)
  w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                  w / torch.where(total != 0, total, torch.ones_like(total)),
                  torch.zeros_like(w))
  w = torch.where(((f >= -0.5) & (f <= n_in - 0.5))[None, :], w,
                  torch.zeros_like(w))
  return w.t().contiguous().to(device)


def resize_bilinear(x, size):
  """NCHW x resized to `size` (H, W) as `jax.image.resize(..., "bilinear")`
  resizes NHWC (`ncsnv2.py:101-103`): both directions, antialiased where it
  shrinks."""
  h, w = x.shape[2:]
  if (h, w) == tuple(size):
    return x
  wh = resize_weights(h, size[0], x.device).to(x.dtype)
  ww = resize_weights(w, size[1], x.device).to(x.dtype)
  return torch.einsum("oh,bchw,pw->bcop", wh, x, ww)


class _Named(nn.Module):
  """A module whose children carry the JAX package's names."""

  def __init__(self):
    super().__init__()
    self.jax_names = {}
    self._jax_counts = {}

  def jax(self, path, cls=None):
    """Record `path` (a child, or a list's entry as "convs.0") under the
    next flax name of `cls` (default: the child's class name)."""
    if cls is None:
      cls = type(self.get_submodule(path)).__name__
    n = self._jax_counts.get(cls, 0)
    self._jax_counts[cls] = n + 1
    self.jax_names[path] = f"{cls}_{n}"


def _apply_norm(norm, x, y):
  return norm(x) if y is None else norm(x, y)


class ConvMeanPool(_Named):
  """A conv, then the mean of each 2x2 patch (`ncsnv2.py:38-50`); with
  `adjust_padding` the input is padded (1, 0) on H and W first."""

  def __init__(self, in_ch, out_ch, kernel=3, adjust_padding=False,
               generator=None, device=None):
    super().__init__()
    self.conv = ncsn_conv(in_ch, out_ch, kernel, generator=generator,
                          device=device)
    self.jax("conv", "Conv")
    self.adjust_padding = adjust_padding

  def forward(self, x):
    if self.adjust_padding:
      x = F.pad(x, (1, 0, 1, 0))
    out = self.conv(x)
    return (out[:, :, ::2, ::2] + out[:, :, 1::2, ::2] + out[:, :, ::2, 1::2]
            + out[:, :, 1::2, 1::2]) / 4.0


class RCUBlock(_Named):
  """Residual conv units (`ncsnv2.py:73-88`): `n_blocks` times, `n_stages`
  of the activation (after the norm of the labels, `norm` given) and a 3x3
  conv without bias, plus the block's input."""

  def __init__(self, features, n_blocks, n_stages, act, norm=None,
               generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act
    self.cond = norm is not None
    for i in range(n_blocks):
      for j in range(n_stages):
        if self.cond:
          setattr(self, f"{i + 1}_{j + 1}_norm", norm(features, **kw))
          self.jax(f"{i + 1}_{j + 1}_norm")
        setattr(self, f"{i + 1}_{j + 1}_conv",
                ncsn_conv(features, features, bias=False, **kw))
        self.jax(f"{i + 1}_{j + 1}_conv", "Conv")

  def forward(self, x, y=None):
    for i in range(self.n_blocks):
      residual = x
      for j in range(self.n_stages):
        if self.cond:
          x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
        x = self.act(x)
        x = getattr(self, f"{i + 1}_{j + 1}_conv")(x)
      x = x + residual
    return x


class CRPBlock(_Named):
  """Chained residual pooling (`ncsnv2.py:53-70`): the activation, then
  `n_stages` times (the norm of the labels,) a 5x5 max (or average) pool
  at stride 1 and a 3x3 conv without bias, each stage's output added to
  the running sum. The conditional block pools by average."""

  def __init__(self, features, n_stages, act, maxpool=True, norm=None,
               generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.act, self.maxpool = act, maxpool
    self.convs = nn.ModuleList()
    self.norms = nn.ModuleList() if norm is not None else None
    for i in range(n_stages):
      if norm is not None:
        self.norms.append(norm(features, **kw))
        self.jax(f"norms.{i}")
      self.convs.append(ncsn_conv(features, features, bias=False, **kw))
      self.jax(f"convs.{i}", "Conv")

  def forward(self, x, y=None):
    x = self.act(x)
    path = x
    for i, conv in enumerate(self.convs):
      if self.norms is not None:
        path = self.norms[i](path, y)
      if self.maxpool:
        path = F.max_pool2d(path, 5, stride=1, padding=2)
      else:
        path = F.avg_pool2d(path, 5, stride=1, padding=2,
                            count_include_pad=True)
      path = conv(path)
      x = path + x
    return x


class MSFBlock(_Named):
  """Multi-scale fusion (`ncsnv2.py:91-104`): each input (normed by the
  labels, `norm` given) through a 3x3 conv, resized to `shape`, summed."""

  def __init__(self, in_planes, features, norm=None, generator=None,
               device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.convs = nn.ModuleList()
    self.norms = nn.ModuleList() if norm is not None else None
    for i, c in enumerate(in_planes):
      if norm is not None:
        self.norms.append(norm(c, **kw))
        self.jax(f"norms.{i}")
      self.convs.append(ncsn_conv(c, features, **kw))
      self.jax(f"convs.{i}", "Conv")

  def forward(self, xs, shape, y=None):
    total = 0.0
    for i, x in enumerate(xs):
      if self.norms is not None:
        x = self.norms[i](x, y)
      total = total + resize_bilinear(self.convs[i](x), shape)
    return total


class RefineBlock(_Named):
  """`ncsnv2.py:107-123`: an RCU block on each input, their fusion where
  there are two, chained residual pooling, an RCU block out (three units at
  the `end`)."""

  def __init__(self, in_planes, features, act, start=False, end=False,
               maxpool=True, norm=None, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    cond = "_Cond" if norm is not None else ""
    self.adapt_convs = nn.ModuleList(
        [RCUBlock(c, 2, 2, act, norm, **kw) for c in in_planes])
    for i in range(len(in_planes)):
      self.jax(f"adapt_convs.{i}", f"{cond}RCUBlock")
    self.msf = (MSFBlock(in_planes, features, norm, **kw)
                if len(in_planes) > 1 else None)
    if self.msf is not None:
      self.jax("msf", f"{cond}MSFBlock")
    self.crp = CRPBlock(features, 2, act, maxpool and norm is None, norm,
                        **kw)
    self.jax("crp", f"{cond}CRPBlock")
    self.output_convs = RCUBlock(features, 3 if end else 1, 2, act, norm,
                                 **kw)
    self.jax("output_convs", f"{cond}RCUBlock")

  def forward(self, xs, output_shape, y=None):
    hs = [rcu(x, y) for rcu, x in zip(self.adapt_convs, xs)]
    h = self.msf(hs, output_shape, y) if self.msf is not None else hs[0]
    return self.output_convs(self.crp(h, y), y)


class ResidualBlock(_Named):
  """The pre-activation residual block (`ncsnv2.py:126-171`, the
  conditional one `:363-401`): norm, activation, conv, norm, activation,
  conv, plus the shortcut. `resample='down'` halves the side by
  ConvMeanPool, or keeps it with dilated convs (`dilation` > 1)."""

  def __init__(self, in_ch, out_ch, act, norm, resample=None, dilation=1,
               adjust_padding=False, cond=False, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.act = act
    self.normalize1 = norm(in_ch, **kw)
    self.jax("normalize1")
    if resample == "down":
      mid = in_ch
      if dilation > 1:
        conv2 = ncsn_conv(mid, out_ch, dilation=dilation, **kw)
        shortcut = ncsn_conv(in_ch, out_ch, dilation=dilation, **kw)
      else:
        conv2 = ConvMeanPool(mid, out_ch, 3, adjust_padding, **kw)
        shortcut = ConvMeanPool(in_ch, out_ch, 1, adjust_padding, **kw)
    else:
      mid = out_ch
      conv2 = ncsn_conv(mid, out_ch, dilation=dilation, **kw)
      shortcut = (None if in_ch == out_ch else
                  ncsn_conv(in_ch, out_ch, 1 if dilation == 1 else 3,
                            dilation=dilation, **kw))
    self.conv1 = ncsn_conv(in_ch, mid, dilation=dilation, **kw)
    self.jax("conv1", "Conv")
    self.normalize2 = norm(mid, **kw)
    self.jax("normalize2")
    self.conv2 = conv2
    self.jax("conv2", "Conv" if isinstance(conv2, nn.Conv2d) else None)
    self.shortcut = shortcut
    if shortcut is not None:
      self.jax("shortcut",
               "Conv" if isinstance(shortcut, nn.Conv2d) else None)
    self.cond = cond

  def forward(self, x, y=None):
    y = y if self.cond else None
    h = self.act(_apply_norm(self.normalize1, x, y))
    h = self.act(_apply_norm(self.normalize2, self.conv1(h), y))
    h = self.conv2(h)
    shortcut = x if self.shortcut is None else self.shortcut(x)
    return shortcut + h


class _RefineNet(_Named):
  """The shared body (`ncsnv2.py:_NCSNv2Base`, `NCSN`): `levels` is a list
  of (width multiple, resample, dilation), two residual blocks each;
  `refine_mults` the refine blocks' widths from the deepest level up.
  `forward(x, labels)` divides by sigma[labels]."""

  LEVELS = ()
  REFINE = ()

  def __init__(self, config, generator=None, device=None, conditional=False):
    super().__init__()
    self.config = config
    m = config.model
    kw = dict(generator=generator, device=device)
    self.act = layers.get_act(m.nonlinearity)
    norm = norm_lib.get_normalization(config, conditional)
    self.conditional = conditional
    nf = m.nf
    channels = config.data.num_channels
    self.register_buffer("sigmas",
                         torch.from_numpy(get_sigmas(config)).to(device),
                         persistent=False)
    cond = "_Cond" if conditional else ""
    self.begin_conv = ncsn_conv(channels, nf, **kw)
    self.jax("begin_conv", "Conv")
    ch = nf
    widths = []
    for k, (mult, resample, dilation) in enumerate(self.LEVELS):
      adjust = (config.data.image_size == 28 and resample == "down"
                and dilation == 4)
      blocks = nn.ModuleList([
          ResidualBlock(ch, mult * nf, self.act, norm, resample, dilation,
                        adjust, conditional, **kw),
          ResidualBlock(mult * nf, mult * nf, self.act, norm, None, dilation,
                        cond=conditional, **kw)])
      setattr(self, f"res{k + 1}", blocks)
      for j in range(2):
        self.jax(f"res{k + 1}.{j}",
                 f"{cond}ResidualBlock" if cond else "ResidualBlockV2")
      ch = mult * nf
      widths.append(ch)
    n = len(self.LEVELS)
    ref_ch = None
    for i in range(n):
      layer_ch = widths[n - 1 - i]
      in_planes = [layer_ch] if ref_ch is None else [layer_ch, ref_ch]
      ref_ch = self.REFINE[i] * nf
      setattr(self, f"refine{i + 1}",
              RefineBlock(in_planes, ref_ch, self.act, start=(i == 0),
                          end=(i == n - 1),
                          norm=norm if conditional else None, **kw))
      self.jax(f"refine{i + 1}", f"{cond}RefineBlock")
    self.normalizer = norm(ref_ch, **kw)
    self.jax("normalizer")
    self.end_conv = ncsn_conv(ref_ch, channels, **kw)
    self.jax("end_conv", "Conv")

  def forward(self, x, labels, generator=None):
    y = labels.long() if self.conditional else None
    h = x if self.config.data.centered else 2 * x - 1.0
    h = self.begin_conv(h)
    feats = []
    for k in range(len(self.LEVELS)):
      for block in getattr(self, f"res{k + 1}"):
        h = block(h, y)
      feats.append(h)
    ref = None
    n = len(feats)
    for i in range(n):
      layer = feats[n - 1 - i]
      xs = [layer] if ref is None else [layer, ref]
      ref = getattr(self, f"refine{i + 1}")(xs, layer.shape[2:], y)
    out = self.act(_apply_norm(self.normalizer, ref, y))
    out = self.end_conv(out)
    used = self.sigmas[labels.long()]
    return out / used.reshape(-1, 1, 1, 1)


class NCSNv2(_RefineNet):
  """`ncsnv2_64`, under 96 pixels (`ncsnv2.py:184-195`). The JAX net
  nests this body as `_NCSNv2Base_0`."""
  LEVELS = ((1, None, 1), (2, "down", 1), (2, "down", 2), (2, "down", 4))
  REFINE = (2, 2, 1, 1)


class NCSNv2_128(_RefineNet):
  """`ncsnv2_128`, 96 to 128 pixels (`ncsnv2.py:198-209`)."""
  LEVELS = ((1, None, 1), (2, "down", 1), (2, "down", 1), (4, "down", 2),
            (4, "down", 4))
  REFINE = (4, 2, 2, 1, 1)


class NCSNv2_256(_RefineNet):
  """`ncsnv2_256`, 128 to 256 pixels (`ncsnv2.py:212-224`)."""
  LEVELS = ((1, None, 1), (2, "down", 1), (2, "down", 1), (2, "down", 1),
            (4, "down", 2), (4, "down", 4))
  REFINE = (4, 2, 2, 2, 1, 1)


class NCSN(_RefineNet):
  """`ncsn`, the class-conditional NCSNv1 (`ncsnv2.py:376-423`): every
  norm a conditional one of the labels, `model.num_classes` classes (which
  the caller sets: no config defines it, in either package), the labels
  the noise levels' indices."""
  LEVELS = NCSNv2.LEVELS
  REFINE = NCSNv2.REFINE

  def __init__(self, config, generator=None, device=None):
    super().__init__(config, generator, device, conditional=True)


def get_network(config):
  """The NCSNv2 class for `data.image_size` (`ncsnv2.py:426-435`)."""
  size = config.data.image_size
  if size < 96:
    return NCSNv2
  if size <= 128:
    return NCSNv2_128
  if size <= 256:
    return NCSNv2_256
  raise NotImplementedError(
      f"No network suitable for {size}px implemented yet.")
