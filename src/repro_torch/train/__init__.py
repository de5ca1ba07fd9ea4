"""Step builders of the port (counterpart of ``repro.train``): the
serving steps; the training step and optimizers wait (ROADMAP, Queue 1)."""
from .step import make_prefill_step, make_decode_fn  # noqa: F401
