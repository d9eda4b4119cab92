"""survey_m_it_s (Mit/s): the window's SA iterations (entries x restarts x
100 per answered query) over the window's wall (host clock).
"""

from satbench.layers import iterations


def read(run):
    if run.window.wall_s <= 0:
        return None
    return iterations(run) / run.window.wall_s / 1e6
