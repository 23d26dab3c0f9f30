"""setup_s (s, host clock): from the process's start to the first timed
hand-over: card init, library load or build, synthesis of the air,
acquisition and warm-up."""


def read(r):
    return r.setup_s
