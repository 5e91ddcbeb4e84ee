"""Parameter placement dispatchers (reference:
python/paddle/fluid/transpiler/ps_dispatcher.py). Mirror of
``paddle_tpu/transpiler/ps_dispatcher.py``, copied: they assign each
parameter of a parameter-server plan its endpoint."""

from __future__ import annotations


class PSDispatcher:
    def __init__(self, eplist):
        self._eps = list(eplist)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    def dispatch(self, varlist):
        return [self.dispatch_one(v) for v in varlist]

    def dispatch_one(self, var):
        ep = self._eps[self._step % len(self._eps)]
        self._step += 1
        return ep


class HashName(PSDispatcher):
    def dispatch(self, varlist):
        return [self.dispatch_one(v) for v in varlist]

    def dispatch_one(self, var):
        # stable across processes: builtin hash() is seed-randomized for
        # strings, which would send trainer pushes and pulls of the same
        # param to different endpoints in different processes
        import zlib
        name = var.name if hasattr(var, "name") else str(var)
        return self._eps[zlib.crc32(name.encode()) % len(self._eps)]
