"""Idle share of the device over the traced window of a reconstruct cell, %."""
from portbench.core.readers import idle_share


def read(r):
    return idle_share(r)
