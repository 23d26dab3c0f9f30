"""realtime_x (x, host clock): seconds of air decoded to ETI, summed
over every ensemble the cell decodes, over the wall seconds of the
window, from the first hand-over's start to the last one's return."""


def read(r):
    if not r.handovers:
        return None
    wall = (r.window[1] - r.window[0]) / 1e9
    return r.ensembles * r.air_s * len(r.handovers) / wall
