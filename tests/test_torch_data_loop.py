"""The port's data on disk and its training loop against the JAX package:
CIFAR-10's python pickles and `<dataset>.npz` through `load_arrays`, the
training batches of `EpochIterator`, the latent data mean of the VE prior
(`eval.data_mean`), and `python -m indm_torch.main` (train, resume, eval).

Data is written to `tmp_path` from a seed in CIFAR-10's own layout (50
images a pickle at 32x32, or an npz at 8x8). The JAX package's training
batches come from its native loader (`indm_tpu/native`, built with g++ at
first use); where it cannot be built that case skips, and the batches are
also held against the numpy fallback's order. The CLI runs the tiny
geometry of `tests/test_torch_train_step.py` on the CPU.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import test_torch_checkpoint as tcp
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import data as torch_data
from indm_torch import main as main_cli
from indm_torch import run_lib
from indm_torch import sde as torch_sde
from indm_tpu import configs as jax_configs
from indm_tpu import data as jax_data
from indm_tpu import native
from indm_tpu import run_lib as jax_run_lib
from indm_tpu import sde as jax_sde
from torch_threads import one_torch_thread  # noqa: F401

tiny_preset = tcp.tiny_preset
PER_BATCH = 50


def write_cifar10(root, seed=0):
  """Five training pickles and a test pickle of PER_BATCH images each, in
  CIFAR-10's layout (`data`: uint8 [N, 3072] in CHW order, `labels`);
  returns the images NHWC."""
  rng = np.random.default_rng(seed)
  base = os.path.join(root, "cifar-10-batches-py")
  os.makedirs(base)
  out = {}
  for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
    x = rng.integers(0, 256, (PER_BATCH, 3, 32, 32), dtype=np.uint8)
    with open(os.path.join(base, name), "wb") as f:
      pickle.dump({b"data": x.reshape(PER_BATCH, -1),
                   b"labels": list(rng.integers(0, 10, PER_BATCH))}, f)
    out[name] = x.transpose(0, 2, 3, 1)
  return out


def configs(name="vp/CIFAR10/indm_nll", **overrides):
  jc, tc = jax_configs.get_config(name), torch_configs.get_config(name)
  for k, v in overrides.items():
    tts._set(jc, k, v)
    tts._set(tc, k, v)
  return jc, tc


def test_cifar10_pickles_load_as_jax_loads_them(tmp_path, monkeypatch):
  """`load_arrays` on the pickles: JAX's arrays bit for bit, the images of
  the files in order, and neither package synthetic; found through
  `$INDM_DATA_DIR` as well as `datadir`."""
  want = write_cifar10(tmp_path)
  jc, tc = configs(datadir=str(tmp_path))
  train, test = torch_data.load_arrays(tc)
  j_train, j_test = jax_data.load_arrays(jc)
  for got, ref in ((train, j_train), (test, j_test)):
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
  np.testing.assert_array_equal(train[PER_BATCH:2 * PER_BATCH],
                                want["data_batch_2"])
  np.testing.assert_array_equal(test, want["test_batch"])
  assert train.shape == (5 * PER_BATCH, 32, 32, 3)
  assert not torch_data.is_synthetic(tc) and not jax_data.is_synthetic(jc)
  monkeypatch.setenv("INDM_DATA_DIR", str(tmp_path))
  _, tc = configs(datadir=str(tmp_path / "elsewhere"))
  np.testing.assert_array_equal(torch_data.eval_dataset(tc).data, test)


def test_npz_and_the_synthetic_fallback_match_jax(tmp_path, caplog):
  """`<dataset>.npz` loads as JAX loads it; with nothing on disk both
  packages fall back to the same seeded images, with the warning; an
  image folder with no image in it is refused rather than passed over
  (image folders are read since CelebA; `tests/test_torch_celeba.py`)."""
  rng = np.random.default_rng(1)
  data = {k: rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
          for k, n in (("train", 40), ("test", 12))}
  np.savez(tmp_path / "cifar10.npz", **data)
  jc, tc = configs(datadir=str(tmp_path), **{"data.image_size": 8})
  for got, ref, raw in zip(torch_data.load_arrays(tc),
                           jax_data.load_arrays(jc), (data["train"],
                                                      data["test"])):
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, raw)
  empty = tmp_path / "empty"
  empty.mkdir()
  jc, tc = configs(datadir=str(empty), **{"data.image_size": 8})
  assert torch_data.is_synthetic(tc) and jax_data.is_synthetic(jc)
  with caplog.at_level("WARNING"):
    got = torch_data.load_arrays(tc)
  assert any("synthetic data" in r.message for r in caplog.records)
  for a, b in zip(got, jax_data.load_arrays(jc)):
    np.testing.assert_array_equal(a, b)
  (empty / "CIFAR10").mkdir()
  assert not torch_data.is_synthetic(tc)
  with pytest.raises(ValueError, match="holds no training image"):
    torch_data.load_arrays(tc)


def _jax_batches(data, batch, flip, seed, n):
  it = jax_data.EpochIterator(data, batch, shuffle=True, random_flip=flip,
                              repeat=True, seed=seed)
  try:
    return [next(it) for _ in range(n)]
  finally:
    it.close()


def test_training_batches_equal_the_native_loaders():
  """`TrainBatches` against `EpochIterator` with the native loader over
  three epochs (50 images, batch 16, the remainder dropped): every batch
  bit for bit, flips included; a resumed iterator goes on with the same
  batches."""
  if native.get_lib() is None:
    pytest.skip("the JAX package's native loader could not be built")
  data = np.random.default_rng(2).integers(0, 256, (50, 8, 8, 3),
                                           dtype=np.uint8)
  want = _jax_batches(data, 16, True, 42, 9)
  tb = torch_data.TrainBatches(data, 16, True, 42)
  got = [next(tb) for _ in range(4)]
  again = torch_data.TrainBatches(data, 16, True, 0)
  again.load_state_dict(tb.state_dict())
  got += [next(again) for _ in range(5)]
  flipped = 0
  for i, (a, b) in enumerate(zip(got, want)):
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=f"batch {i}")
    flipped += int((a != a[:, :, ::-1]).any(axis=(1, 2, 3)).sum())
  assert flipped > 0


def test_training_batches_follow_the_numpy_fallbacks_order(monkeypatch):
  """Without the native loader the JAX iterator gathers in numpy: without
  flips it draws the same permutations, so its batches hold the same
  images in the same order (its /255 a division, the port's the native
  loader's product, within one float32 step)."""
  monkeypatch.setattr(native, "fill_batch", lambda *a, **k: None)
  data = np.random.default_rng(3).integers(0, 256, (50, 8, 8, 3),
                                           dtype=np.uint8)
  want = _jax_batches(data, 16, False, 7, 7)
  tb = torch_data.TrainBatches(data, 16, False, 7)
  for a, b in zip([next(tb) for _ in range(7)], want):
    np.testing.assert_array_equal(np.rint(a * 255), np.rint(b * 255))
    np.testing.assert_allclose(a, b, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("name", ["ve/CIFAR10/indm", "vp/CIFAR10/indm_nll"])
def test_latent_data_mean_matches_jax(name):
  """`compute_latent_data_mean` against `_compute_latent_data_mean` with the
  same flow stand-in (an affine map) on the same shuffled, flipped
  batches: the batch count from `training.batch_size`, the batches at
  `eval.batch_size`, `marginal_prob` to T except under VESDE; rtol 1e-6."""
  if native.get_lib() is None:
    pytest.skip("the JAX package's native loader could not be built")
  jc, tc = configs(name, **{"data.image_size": 8, "eval.batch_size": 6,
                            "training.batch_size": 4,
                            "training.num_train_data": 14})
  data = np.random.default_rng(4).integers(0, 256, (30, 8, 8, 3),
                                           dtype=np.uint8)
  it = jax_data.EpochIterator(data, 6, shuffle=True, random_flip=True,
                              repeat=True, seed=jc.seed)
  try:
    want = jax_run_lib._compute_latent_data_mean(
        jc, jax_sde.get_sde(jc), it, jax_data.get_data_scaler(jc),
        lambda x: (1.5 * x - 0.25, None))
  finally:
    it.close()
  got = run_lib.compute_latent_data_mean(
      tc, torch_sde.get_sde(tc),
      torch_data.TrainBatches(data, 6, True, tc.seed),
      torch_data.get_data_scaler(tc), lambda x: (1.5 * x - 0.25, None),
      "cpu")
  assert got.shape == (3, 8, 8)
  np.testing.assert_allclose(got.permute(1, 2, 0).numpy(),
                             np.asarray(want), rtol=1e-6, atol=1e-7)


# ---- python -m indm_torch.main ----

TINY_ARGS = [a for k, v in {**tts.TINY, "model.dropout": 0.1,
                            "training.log_freq": 2,
                            "training.snapshot_freq": 2,
                            "training.snapshot_freq_for_preemption": 2,
                            "training.snapshot_sampling": False,
                            "optim.reset": False}.items()
             for a in ("--set", f"{k}={v}")]
BPD_ARGS = [a for k, v in {"eval.batch_size": 64, "eval.num_nelbo": 1,
                           "eval.skip_nll_wrong": True, "eval.rtol": 1e-2,
                           "eval.atol": 1e-2}.items()
            for a in ("--set", f"{k}={v}")]


def _train(workdir, n_iters, *extra):
  return main_cli.main(["--mode", "train", "--config", "vp/CIFAR10/indm_nll",
                        "--device", "cpu", "--workdir", str(workdir),
                        *TINY_ARGS, "--set", f"training.n_iters={n_iters}",
                        *extra])


def test_main_train_resumes_to_the_straight_runs_bits(tmp_path):
  """`--mode train` to n_iters 1 (steps 0 and 1), then to 3 in the same
  work directory, against 0 to 3 in another: the same files' tensors bit
  for bit (parameters, moments, EMAs, BatchNorm buffers, generators, the
  batches' place). The log: both lines at steps 0 and 2 with steps a
  second, the config, the checkpoints, and bits/dim at the preemption
  cadence (count 2) with the EMA."""
  a, b = tmp_path / "a", tmp_path / "b"
  first = _train(a, 1, "--set", "eval.enable_bpd=false")
  assert first.step == 2
  resumed = _train(a, 3, "--set", "eval.enable_bpd=false")
  straight = main_cli.main(
      ["--mode", "train", "--config", "vp/CIFAR10/indm_nll", "--device",
       "cpu", "--workdir", str(b), *TINY_ARGS, "--set", "training.n_iters=3",
       *BPD_ARGS])
  assert resumed.step == straight.step == 4
  for name in ("checkpoint.pth", "flow_checkpoint.pth"):
    tcp.assert_same(
        torch.load(a / "checkpoints-meta" / name, weights_only=True),
        torch.load(b / "checkpoints-meta" / name, weights_only=True), name)
  state = torch.load(b / "checkpoints-meta" / "checkpoint.pth",
                     weights_only=True)
  assert state["step"] == 4 and state["rng"]["batches"]["batch_seed"] == 4
  log = (b / "stdout.txt").read_text()
  for step in (0, 2):
    assert f"step: {step}, loss mean: " in log and "steps/s)" in log
    assert f"step: {step}, loss std: " in log
  assert "step: 1, loss mean" not in log
  assert "mean nelbo bpd" in log and "[NLL CORRECT" in log
  assert "synthetic data" in log
  assert (b / "config.txt").read_text().startswith("training.batch_size")
  assert sorted(os.listdir(b / "checkpoints")) == [
      "checkpoint_1.pth", "checkpoint_2.pth", "flow_checkpoint_1.pth",
      "flow_checkpoint_2.pth"]


def test_main_ve_train_then_eval_with_the_data_mean(tmp_path, monkeypatch):
  """The VE config at the tiny VE geometry, on a seeded cifar10.npz of
  16x16 images: `--mode train` for two steps (the Fourier net, FIR
  resampling and importance sampling), then `--mode eval` with
  `eval.data_mean`: bits/dim on the test split, the prior centred at the
  latent mean of the training split, one PC round (FID left out: its
  matrix square root alone takes seconds here, and the FID tests hold
  it)."""
  rng = np.random.default_rng(5)
  np.savez(tmp_path / "cifar10.npz",
           train=rng.integers(0, 256, (24, 16, 16, 3), dtype=np.uint8),
           test=rng.integers(0, 256, (8, 16, 16, 3), dtype=np.uint8))
  ve = [a for k, v in {"datadir": str(tmp_path), "data.image_size": 16,
                       "model.nf": 16, "model.num_res_blocks": 1,
                       "model.ch_mult": (1, 2), "model.attn_resolutions": (8,),
                       "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
                       "flow.model_config": "tiny-train",
                       "training.batch_size": 4, "training.n_iters": 1,
                       "training.log_freq": 1,
                       "training.snapshot_sampling": False,
                       "training.num_train_data": 8, "eval.batch_size": 4,
                       "eval.num_test_data": 4, "eval.num_nelbo": 1,
                       "eval.skip_nll_wrong": True, "eval.rtol": 1e-2,
                       "eval.atol": 1e-2, "eval.num_samples": 2,
                       "sampling.batch_size": 2,
                       "sampling.num_scales": 3}.items()
        for a in ("--set", f"{k}={v}")]
  w = tmp_path / "w"
  common = ["--config", "ve/CIFAR10/indm", "--device", "cpu", "--workdir",
            str(w), *ve]
  tr = main_cli.main(["--mode", "train", *common])
  assert tr.step == 2 and tr.sde.__class__.__name__ == "VESDE"
  log = (w / "stdout.txt").read_text()
  assert "step: 1, loss std: " in log and "synthetic data" not in log
  monkeypatch.setattr(run_lib.evaluation, "compute_fid_and_is",
                      lambda *a, **k: {"fid": None})
  out = main_cli.main(["--mode", "eval", *common, "--set",
                       "eval.data_mean=true"])
  assert out["step"] == 2
  assert np.isfinite(out["bpd"]["nelbo"]) and np.isfinite(
      out["bpd"]["nll_correct"])
  mean = out["data_mean"]
  assert mean.shape == (3, 16, 16) and torch.isfinite(mean).all()
  assert len(out["rounds"]) == 1 and out["rounds"][0]["nfe"] == 2000
  history = (w / "evaluation_history.txt").read_text()
  assert "latent data mean over 8 training images" in history
  with np.load(w / "eval" / "samples_0.npz") as z:
    assert z["samples"].shape == (2, 16, 16, 3)
