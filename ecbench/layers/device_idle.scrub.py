"""The card in the scrub: percent of the traced window with no kernel,
copy or set running (``torch.profiler``)."""

from ecbench.layers._util import device_idle


def read(layer: dict):
    return device_idle(layer)
