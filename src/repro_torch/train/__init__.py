"""Training and serving step builders, the optimizers and the sharding
specs of the port (counterpart of ``repro.train``)."""
from .optimizer import (Optimizer, adafactor, adamw,  # noqa: F401
                        cosine_schedule, get_optimizer)
from .shardings import (batch_specs, cache_specs,  # noqa: F401
                        gather_plan, gather_tree, leaf_axes, local_tree,
                        param_specs, place_params, placed_specs,
                        sanitize_specs)
from .step import (make_decode_fn, make_grad_fn,  # noqa: F401
                   make_prefill_step, make_train_step)
