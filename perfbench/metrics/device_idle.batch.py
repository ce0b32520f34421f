"""Percent of the traced stretch in which no operation ran on the
device."""

from perfbench import readers


def read(res):
    return readers.device_idle(res)
