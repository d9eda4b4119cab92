"""device_idle.interactive (%): the share of the traced window in which the
device ran nothing.
"""

from satbench.layers import idle_share


def read(run):
    return idle_share(run)
