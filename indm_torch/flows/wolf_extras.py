"""The wolf presets' other priors and discriminators (PyTorch): the standard
normal prior, the 'base' discriminator (no latent) and the categorical
discriminator (a class embedding).

Counterpart of `indm_tpu/flows/wolf_extras.py:24-100`. Module names follow
the reference wolf `CategoricalDiscriminator`
(`discriminators/categorical.py`: `embed`, and `net.0`, `net.2`, `net.4`,
the three linear layers of its nn.Sequential with the activations between
them). The dequantizers and the LR schedulers of that file are off the
flow's path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from indm_torch.flows.wolf import _ACTS


class NormalPrior:
  """The standard normal prior (`indm_tpu/flows/wolf_extras.py:24-38`):
  the KL of the Gaussian posterior has its closed form; its draw is
  epsilon itself (`GaussianDiscriminator.sample_from_prior`)."""

  @staticmethod
  def calc_kl(z, eps, mu, logvar):
    return 0.5 * (mu ** 2 + torch.exp(logvar) - logvar - 1.0).sum(dim=1)


class BaseDiscriminator(nn.Module):
  """The 'base' discriminator (`wolf_extras.py:41-56`): no encoder and no
  latent, so the generator runs unconditioned; the KL is 0 and the prior's
  sample is None. It has no parameters."""

  dim = None

  def sampling_and_kl(self, x, eps=None, generator=None, y=None):
    return None, torch.zeros(x.shape[0], device=x.device)

  def sample_from_prior(self, nsamples: int, generator=None, epsilon=None,
                        y=None):
    return None


class CategoricalDiscriminator(nn.Module):
  """The class-conditional 'discriminator' (`wolf_extras.py:59-100`):
  h = MLP(embed(y)) with the KL 0; its prior draws y from the categorical
  with `logits` (log `probs`; uniform when neither is given)."""

  def __init__(self, num_events: int, dim: int, activation: str = "relu",
               probs: Optional[Sequence[float]] = None,
               logits: Optional[Sequence[float]] = None, generator=None,
               device=None):
    super().__init__()
    if probs is not None and logits is not None:
      raise ValueError(
          "Either `probs` or `logits` can be specified, but not both.")
    if probs is not None:
      lg = np.log(np.asarray(probs, np.float32))
    elif logits is not None:
      lg = np.asarray(logits, np.float32)
    else:
      lg = np.zeros((num_events,), np.float32)
    self.register_buffer("logits", torch.from_numpy(lg).to(device),
                         persistent=False)
    self.dim = dim
    self.num_events = num_events
    self.act = _ACTS[activation]
    self.embed = nn.Embedding(num_events, dim, device=device)
    self.net = nn.Sequential(nn.Linear(dim, 4 * dim, device=device),
                             nn.Identity(),
                             nn.Linear(4 * dim, 4 * dim, device=device),
                             nn.Identity(),
                             nn.Linear(4 * dim, dim, device=device))
    if device != "meta":
      with torch.no_grad():
        # flax's uniform(0.2) embedding and lecun-normal dense kernels
        self.embed.weight.uniform_(0.0, 0.2, generator=generator)
        for lin in self.net[::2]:
          lin.weight.normal_(0.0, lin.in_features ** -0.5,
                             generator=generator)
          lin.bias.zero_()

  def encode(self, y):
    h = self.act(self.net[0](self.embed(y.long())))
    h = self.act(self.net[2](h))
    return self.net[4](h)

  def sampling_and_kl(self, x, eps=None, generator=None, y=None):
    """(h, KL = 0) from the labels `y`; the JAX package asserts that it has
    them (`wolf_extras.py:92`), and its joint steps pass none."""
    if y is None:
      raise ValueError(
          "the categorical discriminator encodes only from class labels y, "
          "as the JAX package's CategoricalDiscriminator.sampling_and_KL "
          "asserts (indm_tpu/flows/wolf_extras.py:92); the joint training "
          "steps pass none there, so a categorical preset trains in neither "
          "package")
    z = self.encode(y.to(self.embed.weight.device))
    return z, torch.zeros(z.shape[0], device=z.device)

  def sample_labels(self, nsamples: int,
                    generator: Optional[torch.Generator] = None):
    """y ~ Categorical(logits) [nsamples] from `generator`."""
    probs = torch.softmax(self.logits.float(), dim=0)
    return torch.multinomial(probs, nsamples, replacement=True,
                             generator=generator)

  def sample_from_prior(self, nsamples: int,
                        generator: Optional[torch.Generator] = None,
                        epsilon=None, y: Optional[torch.Tensor] = None):
    """h for labels drawn from the prior; `y` replaces the draw."""
    if y is None:
      y = self.sample_labels(nsamples, generator)
    with torch.no_grad():
      return self.encode(y.to(self.embed.weight.device))
