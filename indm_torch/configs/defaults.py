"""Default configs of the VP and VE INDM experiments, as plain `ConfigDict`s.

A copy of `indm_tpu/configs/defaults.py` (`get_default_configs`,
`_common_indm_flow`, `_vp_model`, `_ve_model`, `vp_indm`, `ve_indm`) with
the same leaf names and values, so that a config written for the JAX
package reads the same here.
The JAX-only `config.jax` section is left out.
"""

from indm_torch.configs import ConfigDict


def get_default_configs(dataset: str = "CIFAR10") -> ConfigDict:
  config = ConfigDict()

  config.training = training = ConfigDict()
  training.batch_size = 128
  training.n_iters = 13000001
  training.snapshot_freq = 10000
  training.log_freq = 100
  training.eval_freq = 100
  training.snapshot_freq_for_preemption = 10000
  training.snapshot_sampling = True
  training.likelihood_weighting = True
  training.continuous = True
  training.reduce_mean = False
  training.importance_sampling = True
  training.unbounded_parametrization = False
  training.ddpm_score = True
  training.st = False
  training.k = 1.2
  training.truncation_time = 1e-5
  training.num_train_data = 50000
  training.reconstruction_loss = False
  training.stabilizing_constant = 0.0

  config.sampling = sampling = ConfigDict()
  sampling.n_steps_each = 1
  sampling.noise_removal = True
  sampling.probability_flow = False
  sampling.snr = 0.16 if dataset == "CIFAR10" else 0.15
  sampling.batch_size = 1024
  sampling.truncation_time = 1e-5
  sampling.temperature = 1.0
  sampling.need_sample = True
  sampling.idx_rand = True
  sampling.pc_denoise = False
  sampling.pc_denoise_time = 0.0
  sampling.more_step = False
  sampling.num_scales = 1000
  sampling.pc_ratio = 1.0
  sampling.begin_snr = 0.16
  sampling.end_snr = 0.16
  sampling.snr_scheduling = "none"

  config.eval = evaluate = ConfigDict()
  evaluate.begin_ckpt = 9 if dataset == "CIFAR10" else 1
  evaluate.end_ckpt = 26
  evaluate.batch_size = 200
  evaluate.enable_sampling = True
  evaluate.num_samples = 50000
  evaluate.enable_loss = True
  evaluate.enable_bpd = True
  evaluate.bpd_dataset = "test"
  evaluate.num_test_data = 10000 if dataset == "CIFAR10" else 19962
  evaluate.residual = False
  evaluate.score_ema = True
  evaluate.flow_ema = False
  evaluate.num_nelbo = 3
  evaluate.rtol = 1e-5
  evaluate.atol = 1e-5
  evaluate.gap_diff = False
  evaluate.target_ckpt = -1
  evaluate.truncation_time = -1.0
  evaluate.data_mean = False
  evaluate.skip_nll_wrong = False

  config.data = data = ConfigDict()
  data.dataset = dataset
  data.image_size = 32 if dataset == "CIFAR10" else 64
  data.random_flip = True
  data.centered = False
  data.num_channels = 3

  config.model = model = ConfigDict()
  # bf16 convs, NIN and attention in the score net, f32 master weights
  # (the VP net; the VE net raises for True)
  model.mixed_precision = False
  # GroupNorm(+swish) through the hand-written kernel
  # (`indm_torch/ops/group_norm.py`); off = the plain per-group statistics
  model.fused_groupnorm = False
  # the TPU's cheaper dropout masks; the port draws its masks from its torch
  # generator either way (`indm_torch/models/layers.py:dropout`)
  model.fast_dropout = False
  model.sigma_min = 0.01
  model.sigma_max = 50 if dataset == "CIFAR10" else 90.0
  model.num_scales = 1000
  model.beta_min = 0.1
  model.beta_max = 20.0
  model.dropout = 0.1
  model.embedding_type = "fourier"
  model.auxiliary_resblock = True
  model.attention = True
  model.fourier_feature = False

  config.optim = optim = ConfigDict()
  optim.optimizer = "AdamW"
  optim.weight_decay = 0.01
  optim.lr = 2e-4
  optim.beta1 = 0.9
  optim.eps = 1e-8
  optim.warmup = 0
  optim.grad_clip = 1.0
  optim.num_micro_batch = 1
  optim.reset = True
  optim.amsgrad = False

  config.flow = flow = ConfigDict()
  flow.model = "identity"
  flow.lr = 1e-3
  flow.ema_rate = 0.999
  flow.optim_reset = False
  flow.nblocks = "16-16"
  flow.intermediate_dim = 512
  flow.resblock_type = "resflow"
  flow.squeeze = dataset != "CIFAR10"
  flow.actnorm = False
  flow.grad_in_forward = False
  flow.act_fn = "sin"
  flow.logdet_unroll = 0
  flow.logdet_bf16 = False
  flow.mixed_precision = False
  flow.logdet_pallas = False
  flow.remat_save_preacts = False
  flow.fused_block = False

  config.seed = 42
  config.datadir = "."
  config.checkpoint_meta_dir = "."
  config.resume = False
  return config


def _common_indm_flow(flow, dataset: str):
  flow.model = "wolf"
  flow.lr = 1e-3
  flow.ema_rate = 0.999
  flow.optim_reset = False
  flow.nblocks = "16-16"
  flow.intermediate_dim = 512
  flow.resblock_type = "resflow"
  if dataset == "CIFAR10":
    flow.model_config = (
        "flow_models/wolf/wolf_configs/cifar10/glow/resflow-gaussian-uni.json")
  else:
    flow.model_config = ("flow_models/wolf/wolf_configs/imagenet/64x64/glow/"
                         "resflow-gaussian-uni.json")
  flow.rank = 1
  flow.local_rank = 0
  flow.batch_size = 512
  flow.eval_batch_size = 4
  flow.batch_steps = 1
  flow.init_batch_size = 1024
  flow.epochs = 500
  flow.valid_epochs = 1
  flow.seed = 65537
  flow.train_k = 1
  flow.log_interval = 10
  flow.warmup_steps = 500
  flow.lr_decay = 0.999997
  flow.beta1 = 0.9
  flow.beta2 = 0.999
  flow.eps = 1e-8
  flow.weight_decay = 0
  flow.amsgrad = True
  flow.grad_clip = 0
  flow.dataset = "cifar10" if dataset == "CIFAR10" else "celeba"
  flow.category = None
  flow.image_size = 32 if dataset == "CIFAR10" else 64
  flow.workers = 4
  flow.n_bits = 8
  flow.recover = -1


def _vp_model(model):
  model.name = "ncsnpp"
  model.scale_by_sigma = False
  model.ema_rate = 0.9999
  model.normalization = "GroupNorm"
  model.nonlinearity = "swish"
  model.nf = 128
  model.ch_mult = (1, 2, 2, 2)
  model.num_res_blocks = 4
  model.attn_resolutions = (16,)
  model.resamp_with_conv = True
  model.conditional = True
  model.fir = False
  model.fir_kernel = [1, 3, 3, 1]
  model.skip_rescale = True
  model.resblock_type = "biggan"
  model.progressive = "none"
  model.progressive_input = "none"
  model.progressive_combine = "sum"
  model.attention_type = "ddpm"
  model.init_scale = 0.0
  model.embedding_type = "positional"
  model.fourier_scale = 16
  model.conv_size = 3


def vp_indm(dataset: str, nll: bool) -> ConfigDict:
  config = get_default_configs(dataset)
  config.training.sde = "vpsde"
  config.training.continuous = True
  config.training.reduce_mean = True
  if not nll:
    config.training.likelihood_weighting = False
    config.training.importance_sampling = False
  config.sampling.method = "ode"
  config.sampling.predictor = "euler_maruyama"
  config.sampling.corrector = "none"
  config.data.centered = True
  _vp_model(config.model)
  _common_indm_flow(config.flow, dataset)
  return config


def _ve_model(model):
  model.name = "ncsnpp"
  model.scale_by_sigma = True
  model.ema_rate = 0.999
  model.normalization = "GroupNorm"
  model.nonlinearity = "swish"
  model.nf = 128
  model.ch_mult = (1, 2, 2, 2)
  model.num_res_blocks = 4
  model.attn_resolutions = (16,)
  model.resamp_with_conv = True
  model.conditional = True
  model.fir = True
  model.fir_kernel = [1, 3, 3, 1]
  model.skip_rescale = True
  model.resblock_type = "biggan"
  model.progressive = "none"
  model.progressive_input = "residual"
  model.progressive_combine = "sum"
  model.attention_type = "ddpm"
  model.init_scale = 0.0
  model.fourier_scale = 16
  model.conv_size = 3


def ve_indm(dataset: str) -> ConfigDict:
  config = get_default_configs(dataset)
  config.training.sde = "vesde"
  config.training.continuous = True
  config.training.likelihood_weighting = True
  config.training.importance_sampling = True
  config.sampling.method = "pc"
  config.sampling.predictor = "reverse_diffusion"
  config.sampling.corrector = "langevin"
  _ve_model(config.model)
  _common_indm_flow(config.flow, dataset)
  return config
