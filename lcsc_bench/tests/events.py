"""Profiler events made by hand, with the methods of kineto's events
that ``lib/trace.py`` and ``lib/spans.py`` read."""
from torch.autograd import DeviceType

CUDA, CPU = DeviceType.CUDA, DeviceType.CPU


class Ev:
    def __init__(self, name, dev, start, dur, *, corr=0, annotation=False,
                 index=0):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._c, self._a, self._i = corr, annotation, index

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def device_index(self):
        return self._i

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


def span(name, start, dur):
    return Ev(name, CPU, start, dur)


def launch(name, start, dur, corr, called_at, index=0):
    """A device activity on card ``index`` and the runtime call that
    launched it."""
    return [Ev(name, CUDA, start, dur, corr=corr, index=index),
            Ev("cudaLaunchKernel", CPU, called_at, 5, corr=corr)]
