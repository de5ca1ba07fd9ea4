from .checkpoint import (list_steps, restore, restore_latest,  # noqa: F401
                         restore_raw, save)
