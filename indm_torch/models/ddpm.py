"""The classic DDPM U-Net (PyTorch, NCHW).

Counterpart of `indm_tpu/models/ddpm.py`: the sinusoidal time embedding,
the legacy DDPM res blocks and attention, nearest-neighbour upsampling and
a strided-conv (or average-pool) downsampling, and `scale_by_sigma`. The
modules live in one flat `all_modules` list, built and consumed in the same
order, with the reference DDPM's state_dict keys (`all_modules.{i}.*`;
the blocks' `GroupNorm_0`, `Conv_0`, `Dense_0`, `NIN_0`, ...).

Where it differs from NCSN++: GroupNorm takes min(32, C) groups, the
residual sums are not rescaled, and `scale_by_sigma` divides by the SMLD
noise level of the integer part of the labels. The down conv is XLA's SAME
stride-2 conv, which pads (0, 1) on an even side and (1, 1) on an odd one.
Under `model.fused_groupnorm` every GroupNorm runs kernel 1 forward (swish
fused where the activation is swish) and kernel 2 backward, as the JAX net
takes the fused Pallas pair. `model.mixed_precision` and
`model.fast_dropout` do not reach the JAX net, which computes in float32
with flax's dropout; the port's net does the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from indm_torch.models import layers
from indm_torch.models.registry import get_sigmas


class ResnetBlockDDPM(nn.Module):
  """The legacy DDPM res block (`indm_tpu/models/ddpm.py:_DDPMResBlock`):
  GroupNorm(min(32, C)) and the activation, a 3x3 conv, the time
  embedding's projection, GroupNorm and the activation, dropout in train
  mode, a 3x3 conv at init scale 0, NIN (`NIN_0`) on the shortcut where the
  width changes, and the plain sum."""

  def __init__(self, in_ch, out_ch, temb_dim=None, act="swish", dropout=0.1,
               fused=False, generator=None, device=None):
    super().__init__()
    kw = dict(generator=generator, device=device)
    self.GroupNorm_0 = layers.GroupNorm(min(32, in_ch), in_ch, act=act,
                                        fused=fused, device=device)
    self.Conv_0 = layers.conv2d(in_ch, out_ch, 3, **kw)
    self.Dense_0 = (layers.linear(temb_dim, out_ch, **kw)
                    if temb_dim is not None else None)
    self.GroupNorm_1 = layers.GroupNorm(min(32, out_ch), out_ch, act=act,
                                        fused=fused, device=device)
    self.Conv_1 = layers.conv2d(out_ch, out_ch, 3, init_scale=0.0, **kw)
    self.NIN_0 = layers.NIN(in_ch, out_ch, **kw) if in_ch != out_ch else None
    self.act = layers.get_act(act)
    self.dropout = dropout

  def forward(self, x, temb=None, generator=None):
    h = self.Conv_0(self.GroupNorm_0(x))
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = self.GroupNorm_1(h)
    if self.training:
      h = layers.dropout(h, self.dropout, generator)
    h = self.Conv_1(h)
    if self.NIN_0 is not None:
      x = self.NIN_0(x)
    return x + h


def pad_same(x, kernel: int, stride: int):
  """NCHW x padded with zeros as XLA's SAME pads it for a conv of `kernel`
  taps at `stride` (the conv then pads nothing): the total that gives
  ceil(n / stride) outputs on each side, its odd one after."""
  pads = []
  for n in (x.shape[3], x.shape[2]):
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    pads += [total // 2, total - total // 2]
  return F.pad(x, pads)


class Downsample(nn.Module):
  """The legacy downsampling (`ddpm.py:104-110`): XLA's SAME stride-2 3x3
  conv (`Conv_0`) under `with_conv`, else a 2x2 average."""

  def __init__(self, channels, with_conv=True, generator=None, device=None):
    super().__init__()
    if with_conv:
      self.Conv_0 = layers.conv2d(channels, channels, 3, stride=2, padding=0,
                                  generator=generator, device=device)
    self.with_conv = with_conv

  def forward(self, x):
    if self.with_conv:
      return self.Conv_0(pad_same(x, 3, stride=2))
    return F.avg_pool2d(x, 2)


class DDPM(nn.Module):
  """DDPM; `forward(x [B,C,H,W], labels [B])` returns float32. In train
  mode the res blocks' dropout masks come from `generator`. `jax_names[i]`
  is the JAX package's name of `all_modules[i]`, which `indm_torch.convert`
  reads: the down and up convs are the DDPM module's own `Conv_{n}` there,
  the `Conv_0` of the reference's `Downsample` and `Upsample` here (the
  latter is NCSN++'s nearest-neighbour `layers.Upsample`)."""

  def __init__(self, config, generator=None, device=None):
    super().__init__()
    self.config = config
    m = config.model
    act = m.nonlinearity.lower()
    self.act = layers.get_act(act)
    nf = self.nf = m.nf
    ch_mult = tuple(m.ch_mult)
    self.num_res_blocks = m.num_res_blocks
    self.num_resolutions = len(ch_mult)
    self.attn_resolutions = tuple(m.attn_resolutions)
    self.conditional = m.conditional
    self.scale_by_sigma = m.scale_by_sigma
    fused = bool(m.get("fused_groupnorm", False))
    kw = dict(generator=generator, device=device)
    self.register_buffer("sigmas",
                         torch.from_numpy(get_sigmas(config)).to(device),
                         persistent=False)
    channels = config.data.num_channels
    mods, names, counts = [], [], {}

    def add(mod, cls):
      mods.append(mod)
      if cls is None:
        names.append(None)
        return
      counts[cls] = counts.get(cls, 0) + 1
      names.append(f"{cls}_{counts[cls] - 1}")

    def resblock(in_ch, out_ch):
      add(ResnetBlockDDPM(in_ch, out_ch, temb_dim=4 * nf, act=act,
                          dropout=m.dropout, fused=fused, **kw),
          "_DDPMResBlock")

    def attnblock(ch):
      add(layers.AttnBlockpp(ch, init_scale=0.0, fused=fused,
                             num_groups=min(32, ch), **kw), "_LegacyAttn")

    if self.conditional:
      add(layers.linear(nf, nf * 4, **kw), "Dense")
      add(layers.linear(nf * 4, nf * 4, **kw), "Dense")
    add(layers.conv2d(channels, nf, 3, **kw), "Conv")
    hs_c = [nf]
    in_ch = nf
    res = config.data.image_size
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        resblock(in_ch, out_ch)
        in_ch = out_ch
        if res in self.attn_resolutions:
          attnblock(in_ch)
        hs_c.append(in_ch)
      if i_level != self.num_resolutions - 1:
        add(Downsample(in_ch, m.resamp_with_conv, **kw),
            "Conv" if m.resamp_with_conv else None)
        hs_c.append(in_ch)
        res = -(-res // 2) if m.resamp_with_conv else res // 2
    in_ch = hs_c[-1]
    resblock(in_ch, in_ch)
    attnblock(in_ch)
    resblock(in_ch, in_ch)
    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        out_ch = nf * ch_mult[i_level]
        resblock(in_ch + hs_c.pop(), out_ch)
        in_ch = out_ch
      if res in self.attn_resolutions:
        attnblock(in_ch)
      if i_level != 0:
        add(layers.Upsample(in_ch, with_conv=m.resamp_with_conv, fir=False,
                            **kw),
            "Conv" if m.resamp_with_conv else None)
        res *= 2
    assert not hs_c
    add(layers.GroupNorm(min(32, in_ch), in_ch, act=act, fused=fused,
                         device=device), "GroupNorm")
    add(layers.conv2d(in_ch, channels, 3, init_scale=0.0, **kw), "Conv")
    self.all_modules = nn.ModuleList(mods)
    self.jax_names = names

  def forward(self, x, labels, generator=None):
    mods = iter(self.all_modules)
    if self.conditional:
      temb = layers.get_timestep_embedding(labels, self.nf)
      temb = next(mods)(temb)
      temb = next(mods)(self.act(temb))
    else:
      temb = None
    h = x if self.config.data.centered else 2 * x - 1.0
    hs = [next(mods)(h)]
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = next(mods)(hs[-1], temb, generator)
        if h.shape[-1] in self.attn_resolutions:
          h = next(mods)(h)
        hs.append(h)
      if i_level != self.num_resolutions - 1:
        hs.append(next(mods)(hs[-1]))
    h = hs[-1]
    h = next(mods)(h, temb, generator)
    h = next(mods)(h)
    h = next(mods)(h, temb, generator)
    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb, generator)
      if h.shape[-1] in self.attn_resolutions:
        h = next(mods)(h)
      if i_level != 0:
        h = next(mods)(h)
    assert not hs
    h = next(mods)(h)  # GroupNorm and the activation
    h = next(mods)(h)
    if self.scale_by_sigma:
      h = h / self.sigmas[labels.long()].reshape(-1, 1, 1, 1)
    return h
