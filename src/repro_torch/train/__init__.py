"""Training and serving step builders and the optimizers of the port
(counterpart of ``repro.train``; the reference's sharding specs have no
counterpart on one card)."""
from .optimizer import (Optimizer, adafactor, adamw,  # noqa: F401
                        cosine_schedule, get_optimizer)
from .step import (make_decode_fn, make_prefill_step,  # noqa: F401
                   make_train_step)
