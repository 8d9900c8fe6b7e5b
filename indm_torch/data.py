"""Data scalers (counterpart of `indm_tpu/data.py:32-42`)."""


def get_data_scaler(config):
  """[0, 1] -> [-1, 1] when the data is centered."""
  if config.data.centered:
    return lambda x: x * 2.0 - 1.0
  return lambda x: x


def get_data_inverse_scaler(config):
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x
