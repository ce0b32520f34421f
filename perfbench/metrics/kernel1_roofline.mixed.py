"""Kernel 1 (the sweep's pool and the backstop's pool) against its
roofline: the least time of the traced calls' work over its device
time."""

from perfbench import readers


def read(res):
    return readers.kernel1_roofline(res)
