"""setup_s: process start to the window's first input tick: the scene,
the kernels' load (and, in a fresh checkout, their build), the bake, the
sizing render, the freeze and graph capture, the cycle's settling renders
and the warm loop. Host clock."""


def read(rec):
    return rec.setup_s
