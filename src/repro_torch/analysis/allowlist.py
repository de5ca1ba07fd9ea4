"""The tracked allowlist of the port's lint — every entry a justified,
counted exemption.

Burn-down contract, as in the reference: the engine errors when the live
count for an entry differs from ``count`` in *either* direction, so the
only way to change this file is to shrink it (fix a site → decrement or
delete the entry).  Adding an entry is a reviewed decision, not a lint
workaround.
"""
from .lint import Allow

ALLOWLIST: tuple[Allow, ...] = ()
