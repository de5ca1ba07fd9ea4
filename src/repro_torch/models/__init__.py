"""The LM stack of the port (counterpart of ``repro.models``): the dense
and MoE families with GQA or MLA attention, the SSM and hybrid families
(Mamba-2 SSD layers, ``mamba``), the encoder–decoder (``lm.encode`` gives
the decoder's memory) and the VLM with its prefix embeddings; the
training loss ``forward_train`` (``lm_loss``, the chunked cross-entropy)."""
from .config import ModelConfig, MoEConfig, MLAConfig, SSMConfig  # noqa: F401
from .lm import (init_params, forward, prefill, decode_step,  # noqa: F401
                 encode, forward_train, init_cache, layer_groups, lm_loss,
                 param_count, tree_leaves)
from .mamba import (ssd_apply, ssd_chunked, ssd_decode_step,  # noqa: F401
                    ssd_init, ssd_reference)
from .moe import moe_apply, moe_init, moe_reference  # noqa: F401
