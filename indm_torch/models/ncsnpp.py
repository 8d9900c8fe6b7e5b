"""NCSN++ score U-Net (PyTorch, NCHW), the VP and VE branches.

Counterpart of `indm_tpu/models/ncsnpp.py`. As in the reference torch
INDM, the modules live in one flat `all_modules` list, built and consumed
in the same order, so the state_dict keys are the reference's
(`all_modules.{i}.*`) and `indm_tpu/models/convert.py` reads them.
The port covers the VP net (positional time embedding, nearest/average
resampling) and the VE net (Gaussian Fourier embedding of sigma, FIR
resampling, the residual input pyramid, output divided by sigma), both
with BigGAN res blocks, their auxiliary resampling blocks and
`progressive='none'`. `model.mixed_precision` runs either net's convs, NIN
and attention in bfloat16 with float32 master weights, float32 GroupNorm
statistics and a float32 output (`indm_tpu/models/ncsnpp.py:32-43`;
`layers`' note). In the VE net the Gaussian Fourier embedding and its two
Dense layers stay float32, as do the input pyramid's FIR convs (their
input is the float32 image and residual sums), the FIR resampling of a
res block takes its input's type (`upfirdn2d._resample`'s note), and the
output divided by sigma is float32 (`indm_tpu/models/layers.py:128-137,
437-566`). `model.fast_dropout` is the same dropout in both nets
(`layers.dropout`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from indm_torch.models import layers

# leaves every ported net has
WANTED = {"resblock_type": "biggan", "progressive": "none",
          "fourier_feature": False, "auxiliary_resblock": True,
          "conditional": True, "nonlinearity": "swish"}
# the leaves that tell the VP net from the VE net
VARIANTS = {
    "vp": {"embedding_type": "positional", "fir": False,
           "progressive_input": "none", "scale_by_sigma": False},
    "ve": {"embedding_type": "fourier", "fir": True,
           "progressive_input": "residual", "scale_by_sigma": True},
}


def _leaf(m, key):
  return m[key].lower() if isinstance(m[key], str) else m[key]


def check_supported(config) -> str:
  """The ported variant ("vp" or "ve") that the config asks for; raises
  NotImplementedError for any other combination of branches."""
  m = config.model
  for key, value in WANTED.items():
    if _leaf(m, key) != value:
      raise NotImplementedError(
          f"model.{key}={m[key]!r} is not ported yet; the port runs "
          f"{value!r}")
  got = {key: _leaf(m, key) for key in VARIANTS["vp"]}
  for name, wanted in VARIANTS.items():
    if got == wanted:
      if name == "ve" and not config.training.continuous:
        raise NotImplementedError("the Fourier embedding needs "
                                  "training.continuous")
      return name
  raise NotImplementedError(
      f"model branches {got} are not ported yet; the port runs "
      f"{VARIANTS['vp']} (VP) or {VARIANTS['ve']} (VE)")


class NCSNpp(nn.Module):
  """NCSN++; `forward(x [B,C,H,W], time_cond [B])` returns float32. In
  train mode the res blocks' dropout masks come from `generator`."""

  def __init__(self, config, generator=None, device=None):
    super().__init__()
    self.variant = check_supported(config)
    self.config = config
    m = config.model
    self.act = layers.get_act(m.nonlinearity)
    nf = m.nf
    ch_mult = tuple(m.ch_mult)
    self.nf = nf
    self.num_res_blocks = m.num_res_blocks
    self.num_resolutions = len(ch_mult)
    self.all_resolutions = [config.data.image_size // (2 ** i)
                            for i in range(self.num_resolutions)]
    self.attn_resolutions = tuple(m.attn_resolutions)
    self.attention = m.attention
    fused = bool(m.get("fused_groupnorm", False))
    self.ve = self.variant == "ve"
    fir, fir_kernel = m.fir, tuple(m.fir_kernel)
    kw = dict(generator=generator, device=device)
    cdt = torch.bfloat16 if m.get("mixed_precision", False) else None
    ckw = dict(kw, compute_dtype=cdt)

    def resblock(in_ch, out_ch=None, up=False, down=False):
      return layers.ResnetBlockBigGANpp(
          in_ch, out_ch, temb_dim=nf * 4, up=up, down=down,
          skip_rescale=m.skip_rescale, init_scale=m.init_scale, fused=fused,
          dropout=m.dropout, fir=fir, fir_kernel=fir_kernel,
          fast_dropout=bool(m.get("fast_dropout", False)), **ckw)

    def attnblock(ch):
      return layers.AttnBlockpp(ch, skip_rescale=m.skip_rescale,
                                init_scale=m.init_scale, fused=fused, **ckw)

    mods = []
    if self.ve:
      mods.append(layers.GaussianFourierProjection(nf, m.fourier_scale,
                                                   **kw))
    mods += [layers.linear(2 * nf if self.ve else nf, nf * 4, **kw),
             layers.linear(nf * 4, nf * 4, **kw)]
    channels = config.data.num_channels
    mods.append(layers.conv2d(channels, nf, 3, **ckw))
    pyramid_ch = channels
    hs_c = [nf]
    in_ch = nf
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        mods.append(resblock(in_ch, out_ch))
        in_ch = out_ch
        if self._attn_at(self.all_resolutions[i_level]):
          mods.append(attnblock(in_ch))
        hs_c.append(in_ch)
      if i_level != self.num_resolutions - 1:
        mods.append(resblock(in_ch, down=True))
        if self.ve:  # the residual input pyramid
          mods.append(layers.Downsample(pyramid_ch, in_ch, with_conv=True,
                                        fir_kernel=fir_kernel, **kw))
          pyramid_ch = in_ch
        hs_c.append(in_ch)

    in_ch = hs_c[-1]
    mods.append(resblock(in_ch))
    mods.append(attnblock(in_ch))
    mods.append(resblock(in_ch))

    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        out_ch = nf * ch_mult[i_level]
        mods.append(resblock(in_ch + hs_c.pop(), out_ch))
        in_ch = out_ch
      if self._attn_at(self.all_resolutions[i_level]):
        mods.append(attnblock(in_ch))
      if i_level != 0:
        mods.append(resblock(in_ch, up=True))
    assert not hs_c

    mods.append(layers.GroupNorm(min(in_ch // 4, 32), in_ch, act="swish",
                                 fused=fused, device=device,
                                 compute_dtype=cdt))
    mods.append(layers.conv2d(in_ch, channels, 3, init_scale=m.init_scale,
                              **ckw))
    self.all_modules = nn.ModuleList(mods)

  def _attn_at(self, res):
    return self.attention and res in self.attn_resolutions

  def forward(self, x, time_cond, generator=None):
    """time_cond: the VP net's labels t * 999, or the VE net's noise
    levels sigma."""
    mods = iter(self.all_modules)
    if self.ve:
      temb = next(mods)(torch.log(time_cond))
    else:
      temb = layers.get_timestep_embedding(time_cond, self.nf)
    temb = next(mods)(temb)
    temb = next(mods)(self.act(temb))
    if not self.config.data.centered:
      x = 2 * x - 1.0

    pyramid = x
    hs = [next(mods)(x)]
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = next(mods)(hs[-1], temb, generator)
        if self._attn_at(h.shape[-1]):
          h = next(mods)(h)
        hs.append(h)
      if i_level != self.num_resolutions - 1:
        h = next(mods)(hs[-1], temb, generator)
        if self.ve:
          pyramid = next(mods)(pyramid) + h
          if self.config.model.skip_rescale:
            pyramid = pyramid / math.sqrt(2.0)
          h = pyramid
        hs.append(h)

    h = hs[-1]
    h = next(mods)(h, temb, generator)
    h = next(mods)(h)
    h = next(mods)(h, temb, generator)

    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb, generator)
      if self._attn_at(h.shape[-1]):
        h = next(mods)(h)
      if i_level != 0:
        h = next(mods)(h, temb, generator)
    assert not hs

    h = next(mods)(h)  # GroupNorm + swish
    h = next(mods)(h)
    if self.config.model.scale_by_sigma:
      h = h / time_cond.reshape(-1, 1, 1, 1)
    return h.float()
