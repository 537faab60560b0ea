"""Spans from the benchmark's own wrappers around calls into the program.

In a traced run, a wrapper put in place of a module attribute times each
call on the host clock, synchronised at its end, and marks it for the
profiler. The spans are kept in memory and summed per name.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Spans:
    def __init__(self, device):
        self.sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
                     else (lambda: None))
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    def wrap(self, name, fn):
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            start = time.perf_counter()
            with record_function(name):
                out = fn(*args, **kwargs)
                self.sync()
            self.seconds[name] += time.perf_counter() - start
            self.calls[name] += 1
            return out

        return wrapped

    @contextmanager
    def around(self, module, attrs):
        """Wrap ``module``'s attributes ``{attr: span name}`` for the body."""
        saved = {attr: getattr(module, attr) for attr in attrs}
        try:
            for attr, name in attrs.items():
                setattr(module, attr, self.wrap(name, saved[attr]))
            yield self
        finally:
            for attr, fn in saved.items():
                setattr(module, attr, fn)
