"""sa_roofline.survey (%): the bound of the window's SA searches
(satbench/bound.py) over the SA kernel's device time in the trace.
"""

from satbench.layers import sa_roofline


def read(run):
    return sa_roofline(run)
