"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, written from the published formulas. It imports
nothing of ``viabel_torch``, ``viabel_tpu`` or ``jax`` and takes nothing
that the program made: it regenerates each model's data from the seed,
draws the same base normals from a generator in the same state, and
works every step out again. Each model and family is a file found by the
name that the configuration gives it (``model_<zoo name>.py``,
``family_<class>.py``).
"""

import importlib.util
from pathlib import Path

_HERE = Path(__file__).resolve().parent


def _load(stem):
    path = _HERE / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_reference_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def model(config, data_seed, dtype, device):
    """The reference log density ``(n, d) -> (n,)`` of a configuration."""
    kw = dict(config["model"])
    return _load(f"model_{kw.pop('zoo')}").build(data_seed=data_seed, dtype=dtype,
                                                 device=device, **kw)


def family(config, dim):
    """The reference family of a configuration."""
    kw = dict(config["family"])
    return _load(f"family_{kw.pop('class')}").Family(dim, **kw)
