"""Idle share of the device over the traced window of a training cell, %
(on more than one chip, the traced rank's)."""
from portbench.core.readers import idle_share


def read(r):
    return idle_share(r)
