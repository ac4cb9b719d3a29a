"""Percent: the least time of the SPR screen steps' work (the window's
``spr_screen_step`` calls, ``roofline.py``) over the device time of every
kernel launched inside their spans."""
from benchmark.metrics.roofline import share


def read(rec):
    return share(rec, "spr_screen_step")
