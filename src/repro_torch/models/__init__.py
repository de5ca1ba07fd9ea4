"""The LM stack of the port, dense family (counterpart of
``repro.models``)."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig  # noqa: F401
from .lm import (init_params, forward, prefill, decode_step,  # noqa: F401
                 init_cache, layer_groups, param_count, tree_leaves)
