"""NCSN++ score U-Net (PyTorch, NCHW), every branch of the JAX net.

Counterpart of `indm_tpu/models/ncsnpp.py`. As in the reference torch
INDM, the modules live in one flat `all_modules` list, built and consumed
in the same order, so the state_dict keys are the reference's
(`all_modules.{i}.*`) and `indm_tpu/models/convert.py` reads them. The
parameterless pyramid resamplers of `progressive_input='input_skip'` and
`progressive='output_skip'` are shared attributes, as in the reference.

Branches: the Gaussian Fourier or positional embedding (with
`scale_by_sigma`, the positional net divides by the SMLD noise level of its
integer labels), `conditional`, `fourier_feature`, DDPM++ or BigGAN res
blocks with any activation, plain or FIR resampling, `auxiliary_resblock`,
`attention`, the input pyramid (`input_skip` or `residual`, combined by
`cat` or `sum`) and the output pyramid (`output_skip` or `residual`).
`check_supported` refuses only what the JAX net asserts against.

`model.mixed_precision` runs the convs, NIN and attention in bfloat16 with
float32 master weights, float32 GroupNorm statistics and a float32 output
(`indm_tpu/models/ncsnpp.py:32-43`; `layers`' note). The Gaussian Fourier
embedding and its two Dense layers stay float32 in the VE net, as do the
FIR convs (their input is the float32 image and residual sums), the FIR
resampling of a res block takes its input's type
(`upfirdn2d._resample`'s note), and the output divided by sigma is
float32 (`indm_tpu/models/layers.py:128-137, 437-566`). `model.fast_dropout`
is the same dropout in every block (`layers.dropout`).
"""

from __future__ import annotations

import torch
from torch import nn

from indm_torch.models import layers
from indm_torch.models.registry import get_sigmas


def _leaf(m, key):
  return m[key].lower() if isinstance(m[key], str) else m[key]


def check_supported(config) -> None:
  """Raise as the JAX net does (`indm_tpu/models/ncsnpp.py:71-73, 95,
  99`): an unknown pyramid, embedding or res-block type, or the Fourier
  embedding without `training.continuous`."""
  m = config.model
  for key, allowed in (("progressive", ("none", "output_skip", "residual")),
                       ("progressive_input", ("none", "input_skip",
                                              "residual")),
                       ("embedding_type", ("fourier", "positional")),
                       ("resblock_type", ("ddpm", "biggan"))):
    if _leaf(m, key) not in allowed:
      raise ValueError(f"model.{key}={m[key]!r} unrecognized; one of "
                       f"{allowed}")
  if _leaf(m, "embedding_type") == "fourier" and not config.training.continuous:
    raise ValueError("the Fourier embedding needs training.continuous")


class NCSNpp(nn.Module):
  """NCSN++; `forward(x [B,C,H,W], time_cond [B])` returns float32. In
  train mode the res blocks' dropout masks come from `generator`.
  `jax_names[i]` is the JAX package's name of `all_modules[i]` (flax's
  `{class}_{n}` in call order; None for a module that is not one there),
  which `indm_torch.convert` reads."""

  def __init__(self, config, generator=None, device=None):
    super().__init__()
    check_supported(config)
    self.config = config
    m = config.model
    self.act_name = _leaf(m, "nonlinearity")
    self.act = layers.get_act(self.act_name)
    nf = m.nf
    ch_mult = tuple(m.ch_mult)
    self.nf = nf
    self.num_res_blocks = m.num_res_blocks
    self.num_resolutions = len(ch_mult)
    self.attn_resolutions = tuple(m.attn_resolutions)
    self.attention = m.attention
    self.conditional = m.conditional
    self.resblock_type = _leaf(m, "resblock_type")
    self.aux = m.auxiliary_resblock
    self.progressive = _leaf(m, "progressive")
    self.progressive_input = _leaf(m, "progressive_input")
    self.fourier = _leaf(m, "embedding_type") == "fourier"
    self.fourier_feature = m.fourier_feature
    self.skip_rescale = m.skip_rescale
    self.scale_by_sigma = m.scale_by_sigma
    ddpm = self.resblock_type == "ddpm"
    fused = bool(m.get("fused_groupnorm", False))
    fir, fir_kernel = m.fir, tuple(m.fir_kernel)
    kw = dict(generator=generator, device=device)
    cdt = torch.bfloat16 if m.get("mixed_precision", False) else None
    self.compute_dtype = cdt
    ckw = dict(kw, compute_dtype=cdt)
    act = self.act_name
    channels = config.data.num_channels
    combine = _leaf(m, "progressive_combine")
    if not self.fourier:
      self.register_buffer(
          "sigmas", torch.from_numpy(get_sigmas(config)).to(device),
          persistent=False)

    def resblock(in_ch, out_ch=None, up=False, down=False):
      common = dict(temb_dim=nf * 4, act=act, dropout=m.dropout,
                    skip_rescale=m.skip_rescale, init_scale=m.init_scale,
                    fused=fused, fast_dropout=bool(m.get("fast_dropout",
                                                         False)), **ckw)
      if ddpm:
        return layers.ResnetBlockDDPMpp(in_ch, out_ch, **common)
      return layers.ResnetBlockBigGANpp(in_ch, out_ch, up=up, down=down,
                                        fir=fir, fir_kernel=fir_kernel,
                                        **common)

    resblock_cls = "ResnetBlockDDPMpp" if ddpm else "ResnetBlockBigGANpp"

    def group_norm(ch):
      return layers.GroupNorm(min(ch // 4, 32), ch, act=act, fused=fused,
                              device=device, compute_dtype=cdt)

    mods, names, counts = [], [], {}

    def add(mod, cls):
      mods.append(mod)
      names.append(None if cls is None else f"{cls}_{bump(cls)}")

    def bump(cls):
      counts[cls] = counts.get(cls, 0) + 1
      return counts[cls] - 1

    if self.fourier:
      add(layers.GaussianFourierProjection(nf, m.fourier_scale, **kw),
          "GaussianFourierProjection")
    if self.conditional:
      add(layers.linear(2 * nf if self.fourier else nf, nf * 4, **kw),
          "Dense")
      add(layers.linear(nf * 4, nf * 4, **kw), "Dense")
    if self.fourier_feature:
      add(layers.FixedFourierProjection(), None)
    add(layers.conv2d(channels * (5 if self.fourier_feature else 1), nf, 3,
                      **ckw), "Conv")
    if self.progressive_input == "input_skip":
      self.pyramid_downsample = layers.Downsample(channels, fir=fir,
                                                  fir_kernel=fir_kernel)
    if self.progressive == "output_skip":
      self.pyramid_upsample = layers.Upsample(channels, fir=fir,
                                              fir_kernel=fir_kernel)

    # the channels of each entry of the forward's `hs`, and the resolution,
    # as the forward will meet them
    hs_c = [nf]
    res = config.data.image_size
    pyramid_ch = channels
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        add(resblock(hs_c[-1], out_ch), resblock_cls)
        if self._attn_at(res):
          add(layers.AttnBlockpp(out_ch, skip_rescale=m.skip_rescale,
                                 init_scale=m.init_scale, fused=fused,
                                 **ckw), "AttnBlockpp")
        hs_c.append(out_ch)
      if i_level == self.num_resolutions - 1:
        continue
      h_ch = hs_c[-1]
      if ddpm:
        add(layers.Downsample(h_ch, with_conv=m.resamp_with_conv, fir=fir,
                              fir_kernel=fir_kernel, **ckw), "Downsample")
      elif self.aux:
        add(resblock(h_ch, down=True), resblock_cls)
      if self.progressive_input == "input_skip":
        bump("Downsample")  # the shared pyramid_downsample
        add(layers.Combine(pyramid_ch, h_ch, combine, **ckw), "Combine")
        h_ch = 2 * h_ch if combine == "cat" else h_ch
      elif self.progressive_input == "residual":
        add(layers.Downsample(pyramid_ch, h_ch, with_conv=True, fir=fir,
                              fir_kernel=fir_kernel, **ckw), "Downsample")
        pyramid_ch = h_ch
      if self.aux:
        hs_c.append(h_ch)
        res //= 2

    h_ch = hs_c[-1]
    if not self.aux:
      hs_c.pop()
    add(resblock(h_ch), resblock_cls)
    add(layers.AttnBlockpp(h_ch, skip_rescale=m.skip_rescale,
                           init_scale=m.init_scale, fused=fused, **ckw),
        "AttnBlockpp")
    add(resblock(h_ch), resblock_cls)

    n_up = self.num_res_blocks + 1 if self.aux else self.num_res_blocks
    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(n_up):
        out_ch = nf * ch_mult[i_level]
        add(resblock(h_ch + hs_c.pop(), out_ch), resblock_cls)
        h_ch = out_ch
      if self._attn_at(res):
        add(layers.AttnBlockpp(h_ch, skip_rescale=m.skip_rescale,
                               init_scale=m.init_scale, fused=fused, **ckw),
            "AttnBlockpp")
      if self.progressive != "none":
        top = i_level == self.num_resolutions - 1
        if self.progressive == "output_skip":
          if not top:
            bump("Upsample")  # the shared pyramid_upsample
          add(group_norm(h_ch), "GroupNorm")
          add(layers.conv2d(h_ch, channels, 3, init_scale=m.init_scale,
                            **ckw), "Conv")
        elif top:
          add(group_norm(h_ch), "GroupNorm")
          add(layers.conv2d(h_ch, h_ch, 3, **ckw), "Conv")
        else:
          add(layers.Upsample(pyramid_ch, h_ch, with_conv=True, fir=fir,
                              fir_kernel=fir_kernel, **ckw), "Upsample")
        pyramid_ch = channels if self.progressive == "output_skip" else h_ch
      if i_level != 0:
        if ddpm:
          add(layers.Upsample(h_ch, with_conv=m.resamp_with_conv, fir=fir,
                              fir_kernel=fir_kernel, **ckw), "Upsample")
          res *= 2
        elif self.aux:
          add(resblock(h_ch, up=True), resblock_cls)
          res *= 2
    assert not hs_c

    if self.progressive != "output_skip":
      add(group_norm(h_ch), "GroupNorm")
      add(layers.conv2d(h_ch, channels, 3, init_scale=m.init_scale, **ckw),
          "Conv")
    self.all_modules = nn.ModuleList(mods)
    self.jax_names = names

  def _attn_at(self, res):
    return self.attention and res in self.attn_resolutions

  def forward(self, x, time_cond, generator=None):
    """time_cond: the positional net's labels (t * 999, or the SMLD
    levels' integer indices), or the Fourier net's noise levels sigma."""
    mods = iter(self.all_modules)
    if self.fourier:
      temb = next(mods)(torch.log(time_cond))
    else:
      temb = layers.get_timestep_embedding(time_cond, self.nf)
    if self.conditional:
      temb = next(mods)(temb)
      temb = next(mods)(self.act(temb))
    else:
      temb = None
    if not self.config.data.centered:
      x = 2 * x - 1.0

    ddpm = self.resblock_type == "ddpm"
    input_pyramid = x
    x_in = next(mods)(x) if self.fourier_feature else x
    hs = [next(mods)(x_in)]
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = next(mods)(hs[-1], temb, generator)
        if self._attn_at(h.shape[-1]):
          h = next(mods)(h)
        hs.append(h)
      if i_level == self.num_resolutions - 1:
        continue
      if ddpm:
        h = next(mods)(hs[-1])
      elif self.aux:
        h = next(mods)(hs[-1], temb, generator)
      if self.progressive_input == "input_skip":
        input_pyramid = self.pyramid_downsample(input_pyramid)
        h = next(mods)(input_pyramid, h)
      elif self.progressive_input == "residual":
        input_pyramid = layers.residual(next(mods)(input_pyramid), h,
                                        self.skip_rescale,
                                        self.compute_dtype)
        h = input_pyramid
      if self.aux:
        hs.append(h)

    h = hs[-1]
    if not self.aux:
      hs.pop()
    h = next(mods)(h, temb, generator)
    h = next(mods)(h)
    h = next(mods)(h, temb, generator)

    pyramid = None
    n_up = self.num_res_blocks + 1 if self.aux else self.num_res_blocks
    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(n_up):
        h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb, generator)
      if self._attn_at(h.shape[-1]):
        h = next(mods)(h)
      if self.progressive != "none":
        if i_level == self.num_resolutions - 1:
          pyramid = next(mods)(h)  # GroupNorm and the activation
          pyramid = next(mods)(pyramid)
        elif self.progressive == "output_skip":
          pyramid = self.pyramid_upsample(pyramid)
          pyramid_h = next(mods)(h)
          pyramid = pyramid + next(mods)(pyramid_h)
        else:
          pyramid = layers.residual(next(mods)(pyramid), h,
                                    self.skip_rescale, self.compute_dtype)
          h = pyramid
      if i_level != 0:
        if ddpm:
          h = next(mods)(h)
        elif self.aux:
          h = next(mods)(h, temb, generator)
    assert not hs

    if self.progressive == "output_skip":
      h = pyramid
    else:
      h = next(mods)(h)  # GroupNorm and the activation
      h = next(mods)(h)
    if self.scale_by_sigma:
      used = time_cond if self.fourier else self.sigmas[time_cond.long()]
      h = h / used.reshape(-1, 1, 1, 1)
    return h.float()
