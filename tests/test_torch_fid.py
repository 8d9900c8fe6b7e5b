"""The port's FID, KID and Inception Score, its PIL-free clean resize, its
InceptionV3 and `compute_fid_and_is` against the JAX package
(`indm_tpu/metrics/fid.py`, `indm_tpu/metrics/inception.py`,
`indm_tpu/evaluation.py:43-186`).

Both networks run on the same weights, carried both ways: the port's
seeded weights through JAX's `convert_torch_state_dict` and
`load_params`, and JAX's `random_params()` through
`indm_torch.convert.inception_state_from_flax`. The networks are compared
on two images at 87 x 87 (a legal size, fast on the CPU) block by block
and whole, and at 299 inside `compute_fid_and_is`. JAX's functions are
jitted here (their eager first calls take about 40 s on the CPU).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import evaluation as torch_evaluation
from indm_torch import image_io
from indm_torch.metrics import fid as torch_fid
from indm_torch.metrics import inception as torch_inception
from indm_tpu import configs as jax_configs
from indm_tpu import evaluation as jax_evaluation
from indm_tpu.metrics import fid as jax_fid
from indm_tpu.metrics import inception as jax_inception
from torch_threads import one_torch_thread  # noqa: F401

# features and logits of a float32 network through ~50 layers, summed in
# another order by XLA and by torch: 1e-5 of the largest value
FEAT_RTOL = 1e-5
SIZE = 87
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=FEAT_RTOL, what=""):
  got, want = np.asarray(got), np.asarray(want)
  assert got.shape == want.shape, what
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err <= rtol, f"{what}: {err:.3e} of the largest value"


@pytest.fixture(scope="module")
def images():
  return np.random.default_rng(0).random((2, SIZE, SIZE, 3)).astype(
      np.float32)


@pytest.fixture(scope="module")
def jax_random():
  """JAX's `random_params()` (jitted) and the port's network on them."""
  variables = jax.jit(jax_inception.random_params)()
  model = torch_inception.InceptionV3FID()
  missing, unexpected = model.load_state_dict(
      convert.inception_state_from_flax(_np(variables)), strict=False)
  assert not unexpected and all(k.endswith("num_batches_tracked")
                                for k in missing)
  model.weights_source = "random"  # JAX's seeded weights
  return variables, model.eval()


def _jax_apply(variables, x):
  return jax.jit(lambda v, x: jax_inception._MODULE.apply(v, x,
                                                          train=False))(
      variables, x)


def test_inception_whole_on_jax_random_params(jax_random, images):
  """JAX's random_params() -> inception_state_from_flax: the same pool
  features and logits."""
  variables, model = jax_random
  pool_j, logits_j = _jax_apply(variables, jnp.asarray(images))
  with torch.no_grad():
    pool_t, logits_t = model(torch.from_numpy(images).permute(0, 3, 1, 2))
  assert pool_t.shape == (2, 2048) and logits_t.shape == (2, 1008)
  _close(pool_t, pool_j, what="pool")
  _close(logits_t, logits_j, what="logits")


def test_inception_block_by_block(jax_random, images):
  """The stem and each Mixed block on the port's own input to it, against
  the flax submodule with the same weights."""
  variables, model = jax_random
  x = torch.from_numpy(images).permute(0, 3, 1, 2)
  with torch.no_grad():
    stem_t = model.stem(x)
  stem_j = jax.jit(_stem)(variables, jnp.asarray(images))
  _close(stem_t.permute(0, 2, 3, 1), stem_j, what="stem")
  blocks = {"Mixed_5b": jax_inception.InceptionA(32),
            "Mixed_5c": jax_inception.InceptionA(64),
            "Mixed_5d": jax_inception.InceptionA(64),
            "Mixed_6a": jax_inception.InceptionB(),
            "Mixed_6b": jax_inception.InceptionC(128),
            "Mixed_6c": jax_inception.InceptionC(160),
            "Mixed_6d": jax_inception.InceptionC(160),
            "Mixed_6e": jax_inception.InceptionC(192),
            "Mixed_7a": jax_inception.InceptionD(),
            "Mixed_7b": jax_inception.InceptionE("avg"),
            "Mixed_7c": jax_inception.InceptionE("max")}
  assert tuple(blocks) == torch_inception.MIXED
  h = stem_t
  for name, block in blocks.items():
    sub = {c: variables[c][name] for c in ("params", "batch_stats")}
    want = jax.jit(lambda v, x: block.apply(v, x))(
        sub, jnp.asarray(h.permute(0, 2, 3, 1).numpy()))
    with torch.no_grad():
      h = getattr(model, name)(h)
    _close(h.permute(0, 2, 3, 1), want, what=name)


# the flax network's layers up to Mixed_5b (`inception.py:166-174`): name,
# features, kernel, keywords; None for the 3x3 stride-2 max pool
STEM = (("Conv2d_1a_3x3", 32, (3, 3), {"strides": (2, 2)}),
        ("Conv2d_2a_3x3", 32, (3, 3), {}),
        ("Conv2d_2b_3x3", 64, (3, 3), {"padding": ((1, 1), (1, 1))}),
        (None, 0, None, {}), ("Conv2d_3b_1x1", 80, (1, 1), {}),
        ("Conv2d_4a_3x3", 192, (3, 3), {}), (None, 0, None, {}))


def _stem(variables, x):
  x = 2 * x - 1
  for name, features, kernel, kw in STEM:
    if name is None:
      x = jax_inception._max_pool(x)
      continue
    x = jax_inception.BasicConv(features, kernel, **kw).apply(
        {c: variables[c][name] for c in ("params", "batch_stats")}, x)
  return x


def test_port_weights_through_jax_converter(tmp_path, images, monkeypatch):
  """The port's seeded state_dict -> JAX's `convert_torch_state_dict` ->
  `load_params`: the same features; the port reports "random" for it."""
  monkeypatch.delenv("INDM_INCEPTION_WEIGHTS", raising=False)
  model = torch_inception.load_inception(device="cpu")
  assert torch_inception.weights_source() == model.weights_source == "random"
  path = jax_inception.convert_torch_state_dict(model.state_dict(),
                                                str(tmp_path / "w.msgpack"))
  variables = jax_inception.load_params(path)
  pool_j, logits_j = _jax_apply(variables, jnp.asarray(images))
  with torch.no_grad():
    pool_t, logits_t = model(torch.from_numpy(images).permute(0, 3, 1, 2))
  _close(pool_t, pool_j, what="pool")
  _close(logits_t, logits_j, what="logits")
  assert np.abs(pool_t.numpy()).max() > 1e-2  # the seeded net keeps scale


def test_load_inception_reads_torch_files(tmp_path):
  """A saved pytorch-fid state_dict and a torchscript archive of the
  tfhub layout both load (`scripts/convert_inception.py`'s two sources);
  the JAX package's msgpack file is refused."""
  model = torch_inception.random_inception(seed=3)
  sd = model.state_dict()
  torch.save(sd, tmp_path / "fid.pth")
  got = torch_inception.load_inception(str(tmp_path / "fid.pth"),
                                       device="cpu")
  assert torch_inception.weights_source() == got.weights_source == str(
      tmp_path / "fid.pth")
  for k, v in got.state_dict().items():
    assert torch.equal(v, sd[k]), k
  # the tfhub names clean-fid's torchscript archive carries, as nested
  # modules' buffers (no BatchNorm scale: TF fixes it at 1)
  tf = {}
  for m in torch_inception.fid_conv_modules():
    unit = torch_inception._tf_unit_name(m)
    tf[f"layers.{unit}.conv.weight"] = sd[f"{m}.conv.weight"]
    for leaf, name in (("bias", "beta"), ("running_mean", "mean"),
                       ("running_var", "var")):
      tf[f"layers.{unit}.bn.{name}"] = sd[f"{m}.bn.{leaf}"]
  tf["layers.output.weight"] = sd["fc.weight"]
  tf["layers.output.bias"] = sd["fc.bias"]
  archive = _Archive()
  for name, v in tf.items():
    *path, leaf = name.split(".")
    mod = archive
    for part in path:
      if not hasattr(mod, part):
        mod.add_module(part, torch.nn.Module())
      mod = getattr(mod, part)
    mod.register_buffer(leaf, v.clone())
  torch.jit.save(torch.jit.script(archive), tmp_path / "ts.pt")
  got = torch_inception.load_inception(str(tmp_path / "ts.pt"), device="cpu")
  for k, v in got.state_dict().items():
    want = torch.ones_like(sd[k]) if k.endswith("bn.weight") else sd[k]
    assert torch.equal(v, want), k
  (tmp_path / "flax.msgpack").write_bytes(b"\x81\xa6params\x80")
  with pytest.raises(ValueError, match="flax"):
    torch_inception.load_inception(str(tmp_path / "flax.msgpack"),
                                   device="cpu")


class _Archive(torch.nn.Module):

  def forward(self, x):
    return x


@pytest.mark.parametrize("size", [8, 13, 299])
def test_bilinear_resize_matches_jax(size):
  """The extractor's resize against `jax.image.resize(..., "bilinear")`:
  up, down (antialiased) and the identity at 299."""
  x = np.random.default_rng(1).random((2, 20, 20, 3)).astype(np.float32)
  if size == 299:
    x = np.random.default_rng(1).random((1, 299, 299, 3)).astype(np.float32)
  want = jax.image.resize(jnp.asarray(x), (x.shape[0], size, size, 3),
                          "bilinear")
  got = torch_inception.resize_bilinear(
      torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  if size == 299:  # both the identity
    assert np.array_equal(got.numpy(), x)
    assert np.array_equal(np.asarray(want), x)


@pytest.mark.parametrize("size", [32, 64])
def test_clean_resize_matches_pil(size):
  """`clean_resize` (no PIL) against JAX's PIL float bicubic, to 1e-3 on
  the 0-255 scale."""
  u8 = np.random.default_rng(size).integers(0, 256, (2, size, size, 3),
                                            dtype=np.uint8)
  want = jax_evaluation.clean_resize(u8)
  got = torch_evaluation.clean_resize(u8, device="cpu")
  assert got.shape == (2, 3, 299, 299) and got.dtype == torch.float32
  np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                             rtol=0, atol=1e-3)


def test_pil_matrix_rows_sum_to_one():
  for n_in, n_out in ((32, 299), (400, 299), (7, 3)):
    w = image_io.pil_bicubic_weights(n_in, n_out)
    np.testing.assert_allclose(w.sum(1), 1.0, rtol=1e-12)


def _features(seed, n=300, d=12, shift=0.0):
  return np.random.default_rng(seed).normal(size=(n, d)) * (1 + shift) \
      + shift


def test_frechet_distance_matches_jax():
  a, b = _features(2), _features(3, shift=0.5)
  mu1, s1 = torch_fid.compute_statistics(a)
  mu2, s2 = torch_fid.compute_statistics(b)
  for got, want in zip((mu1, s1), jax_fid.compute_statistics(a)):
    np.testing.assert_array_equal(got, want)
  want = jax_fid.frechet_distance(mu1, s1, mu2, s2)
  np.testing.assert_allclose(torch_fid.frechet_distance(mu1, s1, mu2, s2),
                             want, rtol=1e-10)
  assert abs(torch_fid.frechet_distance(mu1, s1, mu1, s1)) < 1e-6


def test_frechet_distance_retries_with_eps_and_checks_imaginary(monkeypatch):
  """A non-finite root retries with eps on the diagonals; an imaginary
  diagonal beyond 1e-3 raises, as in JAX."""
  import scipy.linalg
  real = scipy.linalg.sqrtm
  calls = []

  def fake(a, *args, **kwargs):
    calls.append(a)
    if len(calls) == 1:
      return np.full_like(a, np.nan)
    return real(a)

  monkeypatch.setattr(scipy.linalg, "sqrtm", fake)
  mu, s = torch_fid.compute_statistics(_features(4))
  assert abs(torch_fid.frechet_distance(mu, s, mu, s)) < 1e-4
  assert len(calls) == 2
  np.testing.assert_allclose(np.diag(calls[1] - s.dot(s)),
                             2e-6 * np.diag(s), rtol=1e-5)
  monkeypatch.setattr(scipy.linalg, "sqrtm",
                      lambda a: np.eye(len(a)) * (1 + 0.1j))
  with pytest.raises(ValueError, match="Imaginary"):
    torch_fid.frechet_distance(mu, s, mu, s)


def test_newton_schulz_matches_scipy():
  mu1, s1 = torch_fid.compute_statistics(_features(5))
  mu2, s2 = torch_fid.compute_statistics(_features(6, shift=0.3))
  want = torch_fid.frechet_distance(mu1, s1, mu2, s2)
  got = torch_fid.frechet_distance_newton_schulz(mu1, s1, mu2, s2,
                                                 num_iters=50, device="cpu")
  assert got.dtype == torch.float64 and got.device.type == "cpu"
  np.testing.assert_allclose(float(got), want, rtol=1e-6)
  want_j = float(jax_fid.frechet_distance_newton_schulz(mu1, s1, mu2, s2,
                                                        num_iters=50))
  np.testing.assert_allclose(float(got), want_j, rtol=1e-3)


def test_kernel_distance_matches_jax():
  a, b = _features(7, n=120, d=16), _features(8, n=90, d=16, shift=0.2)
  got = torch_fid.kernel_distance(a, b, num_subsets=10, max_subset_size=50)
  want = jax_fid.kernel_distance(a, b, num_subsets=10, max_subset_size=50)
  np.testing.assert_allclose(got, want, rtol=1e-12)


def test_inception_score_matches_jax():
  logits = np.random.default_rng(9).normal(size=(64, 1008)).astype(
      np.float32) * 3
  for splits in (1, 4):
    np.testing.assert_allclose(
        torch_fid.inception_score(logits, splits),
        jax_fid.inception_score(logits, splits), rtol=1e-5)
  assert abs(torch_fid.inception_score(np.zeros((8, 10))) - 1.0) < 1e-6


def test_compute_fid_and_is_matches_jax(tmp_path, jax_random, monkeypatch):
  """`compute_fid_and_is` end to end on a folder of two rounds of two 32 x
  32 images and the repository's CIFAR-10 statistics, against JAX's on the
  same weights (JAX's extractor at a batch of 8, one per virtual device):
  the cached features to FEAT_RTOL, FID, IS and KID (a stats file with raw
  features) to 1e-4, and the same `report_all.npz` keys."""
  variables, model = jax_random
  extractor = jax_inception.feature_extractor
  monkeypatch.setattr(jax_inception, "feature_extractor",
                      lambda params, batch_size=64: extractor(params, 8))
  rng = np.random.default_rng(10)
  rounds = [rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
            for _ in range(2)]
  for side in ("jax", "port"):
    (tmp_path / side).mkdir()
    for r, u8 in enumerate(rounds):
      np.savez(tmp_path / side / f"samples_{r}.npz", samples=u8)
      np.savez(tmp_path / side / f"samples_{r}_before_flow.npz",
               samples=u8 // 2)
  # the FID's statistics: the repository's, as the first candidate; KID's
  # raw real features from the second (`_raw_real_features`)
  assets = tmp_path / "assets"
  (assets / "stats").mkdir(parents=True)
  with np.load(os.path.join(REPO, "cifar10_fid_stats_clean.npz")) as z:
    np.savez(assets / "cifar10_stats.npz", mu=z["mu"], sigma=z["sigma"])
  np.savez(assets / "stats" / "cifar10_stats.npz",
           pool_3=np.abs(rng.normal(size=(6, 2048))) * 0.1)
  cfg_j = jax_configs.get_config("vp/CIFAR10/indm_fid")
  cfg_t = torch_configs.get_config("vp/CIFAR10/indm_fid")
  reports = {}
  reports["jax"] = jax_evaluation.compute_fid_and_is(
      cfg_j, str(tmp_path / "jax"), str(assets), params=variables)
  reports["port"] = torch_evaluation.compute_fid_and_is(
      cfg_t, str(tmp_path / "port"), str(assets), model=model, device="cpu")
  for r in range(2):
    with np.load(tmp_path / "jax" / f"latents_{r}.npz") as zj, \
        np.load(tmp_path / "port" / f"latents_{r}.npz") as zt:
      _close(zt["pool_3"], zj["pool_3"], what="pool_3")
      _close(zt["logits"], zj["logits"], what="logits")
  j, t = reports["jax"], reports["port"]
  assert t["num_samples"] == j["num_samples"] == 4
  for key in ("fid", "inception_score", "kid"):
    np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=key)
  assert t["weights"] == "random" and np.isfinite(t["fid"])
  with np.load(tmp_path / "jax" / "report_all.npz") as zj, \
      np.load(tmp_path / "port" / "report_all.npz") as zt:
    assert set(zt.files) == set(zj.files)


def test_snapshot_sampling_in_training(tmp_path):
  """`train_steps` with a work directory: at a multiple of
  `training.snapshot_freq_for_preemption` under
  `training.snapshot_sampling`, `eval.num_samples` images from the EMA
  score net and the flow go to `samples/iter_{step}/` (round r from seed
  step + 1 + r), with the PNG grid of round 0, and are scored; the row
  carries the report."""
  import test_torch_train_step as tts
  from indm_torch import run_lib
  from indm_torch.configs import wolf_presets as torch_presets
  torch_presets.PRESETS["tiny-train"] = tts.TINY_WOLF
  try:
    cfg = torch_configs.get_config("vp/CIFAR10/indm_fid")
    for k, v in {**tts.TINY, "training.snapshot_freq_for_preemption": 2,
                 "eval.num_samples": 2, "sampling.batch_size": 2,
                 "eval.rtol": 1e-3, "eval.atol": 1e-3}.items():
      tts._set(cfg, k, v)
    cfg.datadir = REPO
    tr = run_lib.build_training(cfg, device="cpu", workdir=str(tmp_path))
    rows = run_lib.train_steps(tr, 2, log=lambda *a: None)
  finally:
    torch_presets.PRESETS.pop("tiny-train", None)
  assert "snapshot" not in rows[0]
  report = rows[1]["snapshot"]
  assert report["num_samples"] == 2 and report["weights"] == "random"
  assert np.isfinite(report["fid"])
  d = tmp_path / "samples" / "iter_2"
  assert sorted(os.listdir(d)) == [
      "latents_0.npz", "report_all.npz", "samples_0.npz", "samples_0.png",
      "samples_0_before_flow.npz"]
