from .checkpoint import list_steps, restore_raw, save  # noqa: F401
