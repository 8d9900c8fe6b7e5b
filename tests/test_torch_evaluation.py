"""The port's bits/dim harness (`indm_torch.evaluation.get_bpd`) against
the JAX package's, and the evaluation and sampling entry points on a
checkpoint.

`get_bpd` runs with stubs whose bits/dim is each image's byte value, as
`tests/test_evaluation.py:141-208` runs the JAX one: both harnesses on the
same test images give the same section values, hand the section
functions the same dequantised batches in the same order, and draw each
batch's noise from the same key (the port seeds a generator where JAX
folds the key into `PRNGKey(step)`). Then the harness's rules (the
in-training counts and cap, the loud failure on a short real dataset, the
`eval.truncation_time = -1` rule, the log lines), and
`python -m indm_torch.evaluate` and `python -m indm_torch.sample
--workdir` on the CPU on a checkpoint that `python -m indm_torch.train`
wrote, each raising without `--device cpu` when there is no card.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_checkpoint as tcp
import test_torch_train_step as tts
from indm_torch import configs as torch_configs
from indm_torch import data as torch_data
from indm_torch import evaluate as evaluate_cli
from indm_torch import evaluation as torch_evaluation
from indm_torch import run_lib
from indm_torch import sample as sample_cli
from indm_torch import train as train_cli
from indm_tpu import configs as jax_configs
from indm_tpu import data as jax_data
from indm_tpu import evaluation as jax_evaluation
from torch_threads import one_torch_thread  # noqa: F401

tiny_preset = tcp.tiny_preset
SECTIONS = ("nelbo", "nelbo_residual", "nll_wrong", "nll_correct",
            "nll_correct_train_eps")


def configs(**overrides):
  jc = jax_configs.get_config("vp/CIFAR10/indm_nll")
  tc = torch_configs.get_config("vp/CIFAR10/indm_nll")
  for c in (jc, tc):
    c.data.image_size = 8
    c.eval.num_nelbo = 1
    for k, v in overrides.items():
      tts._set(c, k, v)
  return jc, tc


def recover(x01):
  """The source byte of each dequantised image in [0, 1], averaged: 256 x
  in [k, k + 1) for byte k."""
  return np.floor(256.0 * x01).mean(axis=tuple(range(1, x01.ndim)))


def run_both(tmp_path, data, step=0, eval=True, **overrides):
  """Both harnesses with recording stubs on `data` as the test split.
  Returns (JAX results, port results, JAX calls, port calls); a call is
  (kind, the batch NHWC in [0, 1], its key or rng, residual, eps)."""
  np.savez_compressed(tmp_path / "cifar10.npz", train=data, test=data)
  jc, tc = configs(**overrides)
  jc.flow.model = "identity"
  jc.datadir = str(tmp_path)
  jcalls, tcalls = [], []

  def record(kind, residual=None):
    def fn(b, rng, eps=None):
      jcalls.append((kind, np.asarray(b), np.asarray(rng), residual,
                     None if eps is None else float(eps)))
    return fn

  inverse = jax_data.get_data_inverse_scaler(jc)

  def j_recover(b):
    return jnp.mean(jnp.floor(256.0 * inverse(b)), axis=(1, 2, 3))

  def j_nelbo(rng, score_fn, ff, b):
    jax.debug.callback(record("nelbo"), b, rng)
    return j_recover(b), j_recover(b)

  def j_nll(rng, score_fn, ff, b, residual=False, eps_bpd=1e-5):
    jax.debug.callback(record("nll", residual), b, rng, eps_bpd)
    return j_recover(b), b, jnp.asarray(1)

  t_inverse = torch_data.get_data_inverse_scaler(tc)

  def t_nelbo(score_fn, ff, b, key):
    x = b.permute(0, 2, 3, 1).numpy()
    tcalls.append(("nelbo", x, key, None, None))
    v = torch.from_numpy(recover(t_inverse(x)))
    return v, v

  def t_nll(score_fn, ff, b, residual, eps_bpd, key):
    x = b.permute(0, 2, 3, 1).numpy()
    tcalls.append(("nll", x, key, residual, float(np.float32(eps_bpd))))
    return torch.from_numpy(recover(t_inverse(x))), b, 3

  _, eval_ds = jax_data.get_dataset(jc, evaluation=True)
  try:
    want = jax_evaluation.get_bpd(jc, eval_ds, jax_data.get_data_scaler(jc),
                                  j_nelbo, j_nll, None, None, step=step,
                                  eval=eval)
  finally:
    eval_ds.close()
  got = torch_evaluation.get_bpd(
      tc, torch_data.EvalBatches(data, tc.eval.batch_size),
      torch_data.get_data_scaler(tc), t_nelbo, t_nll, None, None, step=step,
      eval=eval, device="cpu", log=logging.info,
      draws=lambda step, key, b: {"key": key})
  return want, got, jcalls, tcalls


def test_sections_match_jax_on_the_same_images_in_the_same_order(tmp_path):
  """Ten images whose bytes are their index, 6 to evaluate in batches of
  8, all four sections: every section restarts at image 0 (mean 3.5), and
  each call's batch, dequantisation included, equals JAX's bit for bit,
  with JAX's key for it and its residual and eps."""
  data = np.stack([np.full((8, 8, 3), i, np.uint8) for i in range(10)])
  want, got, jcalls, tcalls = run_both(
      tmp_path, data, step=3,
      **{"eval.num_test_data": 6, "eval.batch_size": 8,
         "eval.skip_nll_wrong": False, "training.truncation_time": 1e-4})
  for key in SECTIONS:
    assert got[key] == pytest.approx(3.5) == want[key], key
  assert got["nll_correct_nfe"] == 3 and got["nll_correct_images"] == 8
  assert len(jcalls) == len(tcalls) == 4
  for (jk, jb, rng, jres, jeps), (tk, tb, key, tres, teps) in zip(jcalls,
                                                                  tcalls):
    assert (jk, jres, jeps) == (tk, tres, teps)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(
        rng, np.asarray(jax.random.fold_in(jax.random.PRNGKey(3), key)))
  assert [c[2] for c in tcalls] == [0, 5_000_000, 6_000_000, 7_000_000]


def test_in_training_counts_and_cap(tmp_path, caplog):
  """In training the count is 10000 (a tenth for the NLL sections), capped
  by a smaller dataset with a warning; the same calls as JAX's."""
  data = np.stack([np.full((8, 8, 3), i, np.uint8) for i in range(40)])
  with caplog.at_level(logging.WARNING):
    want, got, jcalls, tcalls = run_both(
        tmp_path, data, eval=False, **{"eval.batch_size": 8})
  assert "capping" in caplog.text
  for key in ("nelbo", "nll_wrong", "nll_correct"):
    assert got[key] == pytest.approx(want[key]), key
  assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
  assert [c[0] for c in tcalls].count("nelbo") == 5
  assert got["nll_correct_images"] == 8


def test_fails_loudly_on_a_short_real_dataset(monkeypatch):
  """At `eval` a real dataset smaller than `eval.num_test_data` raises
  (the port has only the synthetic set, so a real one is simulated)."""
  _, tc = configs(**{"eval.num_test_data": 10000})
  monkeypatch.setattr(torch_data, "is_synthetic", lambda config: False)
  ds = torch_data.EvalBatches(np.zeros((4, 8, 8, 3), np.uint8), 4)
  with pytest.raises(ValueError, match="refusing"):
    torch_evaluation.get_bpd(tc, ds, lambda x: x, None, None, None, None,
                             eval=True, device="cpu")


def test_synthetic_split_is_the_second_draw():
  """The test split is `default_rng(1234)`'s second draw, after the 512
  training images, as the JAX package makes it; `epoch()` restarts."""
  jc, tc = configs()
  want = jax_data._synthetic(jc)
  got = torch_data.synthetic(tc)
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, b)
  ds = torch_data.eval_dataset(tc)
  assert torch_data.is_synthetic(tc) and len(ds.data) == 128
  first = next(ds.epoch())
  np.testing.assert_array_equal(first, next(ds.epoch()))
  idx = np.arange(tc.eval.batch_size) % 128  # 200 wraps around the 128
  np.testing.assert_array_equal(first, want[1][idx] / np.float32(255.0))


# ---- the entry points on a checkpoint ----

SMALL = [a for k, v in {"eval.rtol": 1e-3, "eval.atol": 1e-3,
                        "eval.num_test_data": 4, "eval.batch_size": 4,
                        "eval.num_nelbo": 1, "eval.skip_nll_wrong": True,
                        "eval.num_samples": 2, "sampling.batch_size": 2,
                        "model.init_scale": 0.0}.items()
         for a in ("--set", f"{k}={v}")]
CLI_ARGS = [a for a in tcp.TRAIN_ARGS if a not in ("--batch", "4")]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, tiny_preset):
  w = tmp_path_factory.mktemp("train")
  train_cli.main([*tcp.TRAIN_ARGS, "--workdir", str(w), "--steps", "2"])
  return w


def test_evaluate_cli(workdir, caplog):
  """`python -m indm_torch.evaluate --device cpu`: the checkpoint's step,
  finite bits/dim in the NELBO and "NLL correct" sections with their
  counts, the section lines with eps 1e-5 (`eval.truncation_time` -1),
  two sampled images under `<workdir>/eval`, and their FID and IS (the
  seeded Inception weights, the repository's CIFAR-10 statistics)."""
  lines = []
  out = run_lib.evaluate(
      _config(CLI_ARGS + SMALL), str(workdir), device="cpu",
      log=lines.append)
  assert out["step"] == 2
  bpd = out["bpd"]
  assert set(bpd) >= {"nelbo", "nelbo_residual", "nll_correct"}
  assert "nll_wrong" not in bpd and "nll_correct_train_eps" not in bpd
  assert all(np.isfinite(bpd[k]) for k in ("nelbo", "nll_correct"))
  assert bpd["nll_correct_images"] == 4 and bpd["nll_correct_nfe"] > 6
  assert any("[NLL CORRECT w/ eps=1.0e-05] section wall-clock" in l
             for l in lines)
  assert any("average nelbo bpd out of 1 evaluations" in l for l in lines)
  assert len(out["rounds"]) == 1
  assert os.path.exists(workdir / "eval" / "samples_0.npz")
  fid = out["fid"]
  assert fid["num_samples"] == 2 and fid["weights"] == "random"
  assert np.isfinite(fid["fid"]) and fid["inception_score"] >= 1.0
  assert lines[-1].startswith("FID: ") and "weights=random" in lines[-1]
  assert os.path.exists(workdir / "eval" / "report_all.npz")
  assert os.path.exists(workdir / "eval" / "latents_0.npz")
  got = evaluate_cli.main([*CLI_ARGS, *SMALL, "--workdir", str(workdir),
                           "--set", "eval.enable_sampling=false"])
  assert got["bpd"]["nll_correct"] == bpd["nll_correct"]


def _config(args):
  """The config `indm_torch.evaluate` builds from these arguments."""
  cfg = torch_configs.get_config("vp/CIFAR10/indm_nll")
  cfg.model.fused_groupnorm = True
  for name, _, value in (args[i + 1].partition("=")
                         for i, a in enumerate(args) if a == "--set"):
    cfg.set_dotted(name, value)
  return cfg


def test_evaluate_refuses_the_latent_data_mean(workdir, monkeypatch):
  """`eval.data_mean` was refused until the VE training slice ported the
  latent data mean. Now the mean is computed over the training split
  (through `marginal_prob` under the VP SDE) and handed to the sampler,
  whose VP prior adds it, as the JAX package's does
  (`indm_tpu/sde.py:VPSDE.prior_sampling`; held in
  `tests/test_torch_pc.py`): the round's images differ from those of a run
  without it (FID stubbed; `test_evaluate_cli` holds it). Each run starts
  from an empty `eval` folder: a round already there is not sampled
  again."""
  import shutil
  monkeypatch.setattr(run_lib.evaluation, "compute_fid_and_is",
                      lambda *a, **k: None)
  args = [*CLI_ARGS, *SMALL, "--workdir", str(workdir), "--set",
          "eval.enable_bpd=false", "--set", "training.num_train_data=8"]
  shutil.rmtree(workdir / "eval", ignore_errors=True)
  out = evaluate_cli.main([*args, "--set", "eval.data_mean=true"])
  mean = out["data_mean"]
  assert mean.shape == (3, 8, 8) and torch.isfinite(mean).all()
  assert out["rounds"][0]["cached"] is None
  with np.load(workdir / "eval" / "samples_0.npz") as z:
    with_mean = z["samples"]
  shutil.rmtree(workdir / "eval")
  assert evaluate_cli.main(args)["data_mean"] is None
  with np.load(workdir / "eval" / "samples_0.npz") as z:
    assert not np.array_equal(z["samples"], with_mean)


def test_sample_cli_reads_the_checkpoint(workdir, tmp_path):
  """`python -m indm_torch.sample --workdir`: the score net on the
  checkpoint's EMA, the flow on its parameters, one round written."""
  cfg = _config(CLI_ARGS + SMALL)
  s = run_lib.build_sampling(cfg, 2, device="cpu", workdir=str(workdir))
  score = torch.load(workdir / "checkpoints-meta" / "checkpoint.pth",
                     weights_only=True)
  flow = torch.load(workdir / "checkpoints-meta" / "flow_checkpoint.pth",
                    weights_only=True)
  tcp.assert_same(list(s.score_model.parameters()),
                  score["ema"]["shadow_params"])
  tcp.assert_same(s.flow_model.state_dict(), flow["model"])
  sample_cli.main([*CLI_ARGS, *SMALL, "--workdir", str(workdir),
                   "--batch", "2"])
  assert os.path.exists(workdir / "eval" / "samples_0_before_flow.npz")


@pytest.mark.parametrize("cli", [evaluate_cli, sample_cli, train_cli])
def test_entry_points_raise_without_a_card(cli, tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device runs")
  args = [a for a in CLI_ARGS + SMALL if a not in ("--device", "cpu")]
  with pytest.raises(RuntimeError, match="no CUDA card"):
    cli.main([*args, "--workdir", str(tmp_path)])
