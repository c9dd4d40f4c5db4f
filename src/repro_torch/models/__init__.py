"""Model stack of the port (see model.py)."""
from repro_torch.models.model import (decode_stacked, encode, forward,
                                      init_cache, init_params,
                                      init_stacked_params, train_loss)
