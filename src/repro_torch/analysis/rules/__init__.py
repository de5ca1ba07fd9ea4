"""The rule registry of the port's lint.  Each module defines one
architecture guardrail; ``DEFAULT_RULES`` is what ``python -m
repro_torch.analysis --check`` and the tests run."""
from .raw_collective import RawCollective
from .stage_plumb import StagePlumb
from .session_bypass import SessionBypass
from .deprecated_api import DeprecatedApi

DEFAULT_RULES = (
    RawCollective(),
    StagePlumb(),
    SessionBypass(),
    DeprecatedApi(),
)

__all__ = ["DEFAULT_RULES", "RawCollective", "StagePlumb", "SessionBypass",
           "DeprecatedApi"]
