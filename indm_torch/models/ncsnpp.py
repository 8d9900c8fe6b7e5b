"""NCSN++ score U-Net (PyTorch, NCHW), the VP branches.

Counterpart of `indm_tpu/models/ncsnpp.py`. As in the reference torch
INDM, the modules live in one flat `all_modules` list, built and consumed
in the same order, so the state_dict keys are the reference's
(`all_modules.{i}.*`) and `indm_tpu/models/convert.py` reads them.
The port covers positional time embedding, BigGAN res blocks with the
auxiliary resampling blocks, `progressive='none'`, no FIR, no input
Fourier features and `scale_by_sigma=False`.
"""

from __future__ import annotations

import torch
from torch import nn

from indm_torch.models import layers


def check_supported(config):
  m = config.model
  wanted = {"embedding_type": "positional", "resblock_type": "biggan",
            "progressive": "none", "progressive_input": "none",
            "fir": False, "fourier_feature": False, "scale_by_sigma": False,
            "auxiliary_resblock": True, "conditional": True,
            "nonlinearity": "swish"}
  for key, value in wanted.items():
    got = m[key].lower() if isinstance(m[key], str) else m[key]
    if got != value:
      raise NotImplementedError(
          f"model.{key}={m[key]!r} is not ported yet (the port runs {value!r})")


class NCSNpp(nn.Module):
  """NCSN++; `forward(x [B,C,H,W], time_cond [B])` returns float32."""

  def __init__(self, config, generator=None, device=None):
    super().__init__()
    check_supported(config)
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
    kw = dict(generator=generator, device=device)

    def resblock(in_ch, out_ch=None, up=False, down=False):
      return layers.ResnetBlockBigGANpp(
          in_ch, out_ch, temb_dim=nf * 4, up=up, down=down,
          skip_rescale=m.skip_rescale, init_scale=m.init_scale, fused=fused,
          **kw)

    def attnblock(ch):
      return layers.AttnBlockpp(ch, skip_rescale=m.skip_rescale,
                                init_scale=m.init_scale, fused=fused, **kw)

    mods = [layers.linear(nf, nf * 4, **kw),
            layers.linear(nf * 4, nf * 4, **kw)]
    channels = config.data.num_channels
    mods.append(layers.conv2d(channels, nf, 3, **kw))
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
                                 fused=fused, device=device))
    mods.append(layers.conv2d(in_ch, channels, 3, init_scale=m.init_scale,
                              **kw))
    self.all_modules = nn.ModuleList(mods)

  def _attn_at(self, res):
    return self.attention and res in self.attn_resolutions

  def forward(self, x, time_cond):
    mods = iter(self.all_modules)
    temb = layers.get_timestep_embedding(time_cond, self.nf)
    temb = next(mods)(temb)
    temb = next(mods)(self.act(temb))
    if not self.config.data.centered:
      x = 2 * x - 1.0

    hs = [next(mods)(x)]
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = next(mods)(hs[-1], temb)
        if self._attn_at(h.shape[-1]):
          h = next(mods)(h)
        hs.append(h)
      if i_level != self.num_resolutions - 1:
        hs.append(next(mods)(hs[-1], temb))

    h = hs[-1]
    h = next(mods)(h, temb)
    h = next(mods)(h)
    h = next(mods)(h, temb)

    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb)
      if self._attn_at(h.shape[-1]):
        h = next(mods)(h)
      if i_level != 0:
        h = next(mods)(h, temb)
    assert not hs

    h = next(mods)(h)  # GroupNorm + swish
    h = next(mods)(h)
    return h.float()
