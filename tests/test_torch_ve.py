"""The port's VE sampling slice (`ve/CIFAR10/indm`) against the JAX package:
VESDE, the PC time grid, the VE NCSN++ score function (Fourier embedding,
FIR resampling, the residual input pyramid, output scaled by 1 / sigma),
the Langevin corrector and the reverse-diffusion predictor, a whole PC
round with the JAX draws replayed, and the sampling CLI.

The geometry is the tiny one of `tests/test_models.py:15-21` (16x16
images, nf 16, one res block, ch_mult (1, 2), attention at 8x8) with
`model.init_scale = 1.0`, so that the blocks' last convs do not start near
zero. The JAX weights (and the Fourier projection's fixed W) are carried
across by `indm_torch.convert`, or the port's seeded weights go to the JAX
model through the JAX package's converter. The port's FIR resampling takes
kernel 9's plain version on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indm_torch import configs as torch_configs
from indm_torch import convert
from indm_torch import run_lib as torch_run_lib
from indm_torch import sample as torch_sample
from indm_torch import sampling as torch_sampling
from indm_torch import sde as torch_sde
from indm_torch.models import registry as torch_registry
from indm_torch.models.ncsnpp import NCSNpp
from indm_torch.ops import group_norm as gn
from indm_torch.ops import upfirdn2d as fir
from indm_tpu import configs as jax_configs
from indm_tpu import data as jax_data
from indm_tpu import sampling as jax_sampling
from indm_tpu import sde as jax_sde
from indm_tpu.flows import convert as jax_flow_convert
from indm_tpu.flows import flow_model as jax_fm
from indm_tpu.models import create_model as jax_create_model
from indm_tpu.models import get_score_fn as jax_get_score_fn
from indm_tpu.models.convert import ncsnpp_params_from_torch
from indm_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from torch_threads import one_torch_thread  # noqa: F401

NAME = "ve/CIFAR10/indm"
TINY = {"data.image_size": 16, "model.nf": 16, "model.num_res_blocks": 1,
        "model.ch_mult": (1, 2), "model.attn_resolutions": (8,),
        "model.init_scale": 1.0}
# the tiny flow of tests/test_torch_sampling.py, and a PC round of 6 scales
ROUND = {**TINY, "flow.nblocks": "2-2", "flow.intermediate_dim": 8,
         "model.num_scales": 6, "sampling.num_scales": 6}
B = 4
SHAPE = (B, 16, 16, 3)
# the score against JAX: the port's sums run in another order, and
# sigma(t) = sigma_min (sigma_max / sigma_min)^t may differ in the last bit
# between the two pow functions; the Fourier arguments reach ~1e3 rad, so
# the tolerance is the one of the VP score test, 5e-5 of the score's scale
SCORE_TOL = 5e-5


def _set(cfg, name, value):
  *path, leaf = name.split(".")
  node = cfg
  for p in path:
    node = getattr(node, p)
  setattr(node, leaf, value)


def tiny_configs(overrides=TINY):
  jc = jax_configs.get_config(NAME)
  tc = torch_configs.get_config(NAME)
  for k, v in overrides.items():
    _set(jc, k, v)
    _set(tc, k, v)
  return jc, tc


def _np_tree(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
  return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
      0, 3, 1, 2)))


def _nhwc(t):
  return t.permute(0, 2, 3, 1).numpy()


def _close_to_scale(got, want, tol):
  want = np.asarray(want)
  scale = np.abs(want).max()
  np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=tol)


@pytest.fixture(scope="module")
def nets():
  """The tiny JAX VE net with random weights and the port's net with the
  same weights; both score functions."""
  jc, tc = tiny_configs()
  module, variables = jax_create_model(jc, jax.random.PRNGKey(0))
  tree = _np_tree(variables)
  model = NCSNpp(tc)
  model.load_state_dict(convert.score_state_dict_from_jax(
      tree["params"], tc, tree["buffers"]), strict=True)
  model.eval()
  j_sde, t_sde = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  j_score = jax.jit(jax_get_score_fn(jc, j_sde, module, variables,
                                     train=False, continuous=True))
  t_score = torch_registry.get_score_fn(tc, t_sde, model)
  return dict(jc=jc, tc=tc, module=module, variables=variables, model=model,
              j_sde=j_sde, t_sde=t_sde, j_score=j_score, t_score=t_score)


def test_vesde_matches_jax():
  """sde, marginal_prob, prior_sampling (replayed noise and a data mean),
  prior_logp, the noise-level table and both branches of discretize, at
  rtol 1e-6. The truncating branch takes grid times of the config's 1000
  scales, where t * 999 lies within one float32 step of an integer. The
  explicit branch, G = sqrt(sigma(t)^2 - sigma(next_t)^2), is checked at
  next_t = t / 2 and at the grid's next time. G of adjacent noise levels
  (the table's in the truncating branch) is a difference of squares that
  multiplies the last-bit differences of sigma (torch's and XLA's pow
  differ in 2 % of float32 inputs, their exp and linspace too) by
  sigma^2 / G^2, about 60 at 1000 scales: G's tolerance is 1e-6 times
  that factor."""
  jc, tc = tiny_configs()
  j, t = jax_sde.get_sde(jc), torch_sde.get_sde(tc)
  rng = np.random.default_rng(0)
  x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
  grid = np.asarray(jnp.linspace(j.T, 1e-5, j.N))
  ts = grid[[0, 1, 500, 998]]
  xj, xt, tt = jnp.asarray(x), _nchw(x), torch.from_numpy(ts)
  rtol = 1e-6

  np.testing.assert_allclose(t.discrete_sigmas.numpy(),
                             np.asarray(j.discrete_sigmas), rtol=rtol)
  (dj, gj), (dt, gt) = j.sde(xj, jnp.asarray(ts)), t.sde(xt, tt)
  np.testing.assert_array_equal(_nhwc(dt), np.asarray(dj))
  np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=rtol)
  (mj, sj), (mt, st) = (j.marginal_prob(xj, jnp.asarray(ts)),
                        t.marginal_prob(xt, tt))
  np.testing.assert_array_equal(_nhwc(mt), np.asarray(mj))
  np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol)
  np.testing.assert_allclose(t.prior_logp(xt * 30).numpy(),
                             np.asarray(j.prior_logp(xj * 30)), rtol=rtol)

  key = jax.random.PRNGKey(4)
  mean = x[:1] * 0.1
  pj = np.asarray(j.prior_sampling(key, x.shape, jnp.asarray(mean)))
  z = np.asarray(jax.random.normal(key, x.shape))
  pt = t.prior_sampling(None, device="cpu", noise=_nchw(z),
                        data_mean=_nchw(mean))
  np.testing.assert_allclose(_nhwc(pt), pj, rtol=rtol)

  for nt in (None, ts / 2, grid[[1, 2, 501, 999]]):
    fj, Gj = j.discretize(xj, jnp.asarray(ts),
                          None if nt is None else jnp.asarray(nt))
    ft, Gt = t.discretize(xt, tt, None if nt is None else torch.from_numpy(nt))
    np.testing.assert_array_equal(_nhwc(ft), np.asarray(fj))
    Gj = np.asarray(Gj)
    cond = np.max(np.asarray(sj) ** 2 / Gj ** 2)
    np.testing.assert_allclose(Gt.numpy(), Gj, rtol=rtol * cond)


@pytest.mark.parametrize("num", [6, 200, 1000])
def test_time_grid_matches_jnp_linspace(num):
  """The PC grid `linspace(T, eps, num)` against `jnp.linspace`: the same
  bits at the round test's 6 scales; at larger `num` XLA's CPU code
  reassociates the formula and contracts it to fused multiply-adds, so
  the grids agree within one float32 step of 1.0, and the predictor's
  truncated indices t * (N - 1) agree everywhere, for N = num and for the
  config's N = 1000."""
  ours = torch_sde.linspace_f32(1.0, 1e-5, num)
  theirs = np.asarray(jnp.linspace(1.0, 1e-5, num))
  assert ours.dtype == np.float32 and ours.shape == theirs.shape
  assert np.abs(ours - theirs).max() <= 2.0 ** -24
  if num == 6:
    np.testing.assert_array_equal(ours, theirs)
  for n in (num, 1000):
    np.testing.assert_array_equal(
        (ours * np.float32(n - 1)).astype(np.int32),
        (theirs * np.float32(n - 1)).astype(np.int32))


@pytest.mark.parametrize("fused", [False, True])
def test_ve_score_fn_matches_jax(nets, fused):
  """Scores at several t, GroupNorm through the kernel path (`fused`, its
  plain version on the CPU; interpret-mode Pallas on the JAX side) or
  through the per-group statistics; the FIR resampling through kernel 9's
  plain version (no launch on the CPU)."""
  jc, tc = tiny_configs({**TINY, "model.fused_groupnorm": fused})
  module = JaxNCSNpp(jc)
  j_score = jax.jit(jax_get_score_fn(jc, nets["j_sde"], module,
                                     nets["variables"], train=False,
                                     continuous=True))
  model = NCSNpp(tc)
  model.load_state_dict(nets["model"].state_dict(), strict=True)
  model.eval()
  t_score = torch_registry.get_score_fn(tc, nets["t_sde"], model)
  x = 5 * np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
  gn.reset_launches()
  fir.reset_launches()
  for tval in (1e-5, 1e-3, 0.1, 0.5, 1.0):
    t = np.full((B,), tval, np.float32)
    s_j = np.asarray(j_score(jnp.asarray(x), jnp.asarray(t)))
    s_t = _nhwc(t_score(_nchw(x), torch.from_numpy(t)))
    assert np.abs(s_j).max() > 1e-2  # the net's output is not degenerate
    _close_to_scale(s_t, s_j, SCORE_TOL)
  assert gn.launches == 0 and fir.launches == 0


def test_score_weights_round_trip_ve(nets):
  """JAX params and buffers -> port state_dict -> the JAX package's torch
  converter -> the same params and the same Fourier W (under the reference
  key `all_modules.0.W`, the FIR convs under `Conv2d_0`); and the port's
  own initial state_dict survives the way back."""
  jc, tc = tiny_configs()
  tree = _np_tree(nets["variables"])
  sd = convert.score_state_dict_from_jax(tree["params"], tc, tree["buffers"])
  assert "all_modules.0.W" in sd
  assert any(k.endswith("Conv2d_0.weight") for k in sd)
  back, buffers = ncsnpp_params_from_torch(sd, jc)
  flat_a = jax.tree_util.tree_leaves_with_path(tree["params"])
  flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
  assert len(flat_a) == len(flat_b)
  for path, leaf in flat_a:
    np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
  np.testing.assert_array_equal(buffers["GaussianFourierProjection_0"]["W"],
                                tree["buffers"]["GaussianFourierProjection_0"]
                                ["W"])

  ours = torch_registry.create_model(tc, seed=3, device="cpu").state_dict()
  params, bufs = ncsnpp_params_from_torch(ours, jc)
  again = convert.score_state_dict_from_jax(_np_tree(params), tc,
                                            _np_tree(bufs))
  assert set(again) == set(ours)
  for k, v in ours.items():
    torch.testing.assert_close(again[k], v, atol=0, rtol=0)


def test_predictor_and_corrector_match_jax(nets):
  """The reverse-diffusion predictor (next_t=None: the SMLD table's
  truncated index) and two Langevin steps (snr 0.16, alpha 1) on the same
  x and t, with the JAX draws replayed: the predictor's normal from its
  key, the corrector's from split(key) per step."""
  j_sde, t_sde = nets["j_sde"], nets["t_sde"]
  x = 10 * np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
  t = np.full((B,), np.asarray(jnp.linspace(1.0, 1e-5, 1000))[400],
              np.float32)
  key = jax.random.PRNGKey(3)
  xj, tj, xt, tt = jnp.asarray(x), jnp.asarray(t), _nchw(x), torch.tensor(t)

  j_pred = jax_sampling.reverse_diffusion_predictor(j_sde, nets["j_score"])
  t_pred = torch_sampling.reverse_diffusion_predictor(t_sde,
                                                      nets["t_score"])
  z = np.asarray(jax.random.normal(key, SHAPE))
  for ours, theirs in zip(t_pred(xt, tt, None, noise=_nchw(z)),
                          jax.jit(j_pred)(key, xj, tj)):
    _close_to_scale(_nhwc(ours), theirs, SCORE_TOL)

  j_corr = jax_sampling.langevin_corrector(j_sde, nets["j_score"], 0.16, 2)
  t_corr = torch_sampling.langevin_corrector(t_sde, nets["t_score"], 0.16,
                                             2)
  noise, rng = [], key
  for _ in range(2):
    rng, step_rng = jax.random.split(rng)
    noise.append(_nchw(jax.random.normal(step_rng, SHAPE)))
  for ours, theirs in zip(t_corr(xt, tt, noise=noise),
                          jax.jit(j_corr)(key, xj, tj)):
    _close_to_scale(_nhwc(ours), theirs, SCORE_TOL)


def test_pc_round_matches_jax_with_replayed_noise():
  """One whole PC round of 6 scales (`model.num_scales = sampling.num_scales
  = 6`) with the tiny flow: the port's seeded weights go to the JAX models
  through the JAX package's converters, and the JAX draws are replayed:
  split(rng) -> the prior; per step split(rng, 3) -> (rng, corrector,
  predictor), the corrector's step key split once more; the flow prior's
  epsilon from split(PRNGKey(0)). The images before and after the flow and
  the step-(N-2) mean agree within 1e-4 of their largest magnitude (as the
  ODE round's test); the evaluation counts are equal."""
  pc_round_matches_jax(*tiny_configs(ROUND), SHAPE)


def pc_round_matches_jax(jc, tc, shape):
  """The body of `test_pc_round_matches_jax_with_replayed_noise` for the
  configs (jc, tc) and images of `shape` (NHWC)."""
  s = torch_run_lib.build_sampling(tc, B, device="cpu", seed=5)
  score_sd, flow_sd = s.score_model.state_dict(), s.flow_model.state_dict()
  params, buffers = ncsnpp_params_from_torch(score_sd, jc)
  fparams = {
      "resflow": jax_flow_convert.resflow_params_from_torch(flow_sd, jc),
      "disc": {"prior": {
          f"steps_{i}": jax_flow_convert._prior_step(
              flow_sd, f"discriminator.prior.flow.steps.{i}")
          for i in range(len(s.flow_model.discriminator.prior.flow.steps))}}}
  fbuffers = {"batch_stats": {}}
  module = JaxNCSNpp(jc)
  fm = jax_fm.create_flow_model(jc)
  j_sde = jax_sde.get_sde(jc)
  sampler = jax_sampling.get_sampling_fn(
      jc, j_sde, shape, jax_data.get_data_inverse_scaler(jc),
      jc.sampling.truncation_time)
  score_fn = jax_get_score_fn(jc, j_sde, module,
                              {"params": params, "buffers": buffers},
                              train=False, continuous=True)
  flow_inverse = lambda x: jax_fm.flow_forward(jc, fm, fparams, fbuffers, x,
                                               reverse=True)[0]
  rng = jax.random.PRNGKey(11)
  out_j = jax.jit(lambda r: sampler(r, score_fn, flow_inverse))(rng)

  rng, prior_rng = jax.random.split(rng)
  prior = _nchw(jax.random.normal(prior_rng, shape))
  steps = []
  for _ in range(jc.sampling.num_scales):
    rng, c_rng, p_rng = jax.random.split(rng, 3)
    _, step_rng = jax.random.split(c_rng)
    steps.append(([_nchw(jax.random.normal(step_rng, shape))],
                  _nchw(jax.random.normal(p_rng, shape))))
  rng_h = jax.random.split(jax.random.PRNGKey(0))[0]
  eps = np.array(fm.disc.apply(
      {"params": fparams["disc"], **fbuffers}, B,
      method=lambda m, n: jax.random.normal(m.make_rng("sample"), (n, m.dim)),
      rngs={"sample": rng_h}))

  fir.reset_launches()
  out_t = torch_run_lib.sample_round(tc, s, prior_noise=prior,
                                     prior_eps=torch.from_numpy(eps),
                                     step_noise=steps.__getitem__)
  assert fir.launches == 0
  assert out_t[3] == int(out_j[3]) == (jc.model.num_scales * (
      jc.sampling.n_steps_each + 1))  # sde.N * (n_steps + 1)
  for ours, theirs in zip(out_t[:3], out_j[:3]):
    assert ours.shape == shape
    _close_to_scale(ours.numpy(), theirs, 1e-4)


def _cli_args(tmp_path, extra=()):
  args = ["--config", NAME, "--batch", "2", "--rounds", "1", "--workdir",
          str(tmp_path), "--device", "cpu"]
  for k, v in {**ROUND, "model.num_scales": 3,
               "sampling.num_scales": 3}.items():
    args += ["--set", f"{k}={v}"]
  for item in extra:
    args += ["--set", item]
  return args


def test_ve_sample_entry_point_writes_round(tmp_path, capsys):
  """`python -m indm_torch.sample --config ve/CIFAR10/indm --device cpu` at
  the tiny size: the round's npz files (uint8 NHWC), the step-(N-2) mean
  for the denoise search among them, and its line of stats."""
  torch_sample.main(_cli_args(tmp_path))
  out = capsys.readouterr().out
  assert out.count("nfe=6") == 1 and "images/s=" in out
  for name in ("samples_0.npz", "samples_0_before_flow.npz",
               "samples_0_before_flow_for_search.npz"):
    with np.load(tmp_path / "eval" / name) as z:
      assert z["samples"].dtype == np.uint8
      assert z["samples"].shape == (2, 16, 16, 3)


@pytest.mark.parametrize("leaf", ["model.mixed_precision",
                                  "model.fast_dropout"])
def test_precision_switches_raise(tmp_path, leaf):
  """Neither switch raises now in either net: the VP net and the VE net
  build under each, and the VE PC round runs under each through the
  sampling CLI (`model.mixed_precision`: the VE net's convs in bfloat16,
  its FIR resampling on bfloat16 values through kernel 9's float32 body,
  here the plain version; `model.fast_dropout` the same dropout)."""
  for name in ("vp/CIFAR10/indm_nll", NAME):
    cfg = torch_configs.get_config(name)
    _set(cfg, leaf, True)
    NCSNpp(cfg, device="meta")
  torch_sample.main(_cli_args(tmp_path, [f"{leaf}=true"]))
  with np.load(tmp_path / "eval" / "samples_0.npz") as z:
    assert z["samples"].shape == (2, 16, 16, 3)


@pytest.mark.parametrize("leaf,value", [
    ("sampling.pc_denoise", True), ("sampling.more_step", True),
    ("sampling.predictor", "euler_maruyama"), ("sampling.corrector", "ald"),
    ("sampling.snr_scheduling", "linear"), ("training.sde", "vpsde")])
def test_unported_pc_variants_raise(leaf, value):
  """The six PC variants that raised until the port's score side came in
  (the denoise search and the extra steps with `sampling.need_sample`
  off, the Euler-Maruyama predictor, the ALD corrector, the linear SNR
  schedule, the VE config's PC sampler under the VP SDE) now run and
  match the JAX sampler on the VE config at 5 scales, with an analytic
  score and JAX's draws replayed (`tests/test_torch_pc.py`'s rounds):
  within 1e-4 of the largest value, as the VE round above."""
  import test_torch_pc as tpc
  leaves = {"sampling.method": "pc", leaf: value,
            "sampling.need_sample": False, "sampling.begin_snr": 0.3,
            "sampling.end_snr": 0.05}
  jc, tc = tpc.configs("vesde", **leaves)
  out_t, out_j = tpc.round_pair(jc, tc, flow=True, final_time=0.2)
  tpc.check_round(out_t, out_j)


def test_mixed_ve_and_vp_branches_raise():
  """Every branch of the JAX net is ported since the score-net slice
  (`tests/test_torch_ncsnpp_branches.py`): a VE net with the VP
  resampling builds, and what raises is what the JAX net asserts against,
  here the Fourier embedding without `training.continuous`."""
  _, tc = tiny_configs()
  tc.model.fir = False
  NCSNpp(tc, device="meta")
  tc.training.continuous = False
  with pytest.raises(ValueError, match="continuous"):
    NCSNpp(tc, device="meta")
