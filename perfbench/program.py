"""The system under test, built from a configuration and a traffic mix.

Only this module and the kinds import ``viabel_torch``. A configuration
names the zoo model, the family and the objective by their classes in
``viabel_torch`` and gives ``bbvi``'s arguments; a traffic mix may add
to the objective's and ``bbvi``'s arguments. Nothing here knows a cell.
"""

import torch

#: torch.Generator seeds and numpy's RandomState take these ranges
_SEED_MOD = 2 ** 63
_DATA_SEED_MOD = 2 ** 32


def data_seed(seed):
    """The model's data seed (numpy's RandomState takes 32 bits)."""
    return int(seed) % _DATA_SEED_MOD


def generator_seed(seed, stream=0):
    """A torch.Generator seed for ``stream`` of a run (0: the fit)."""
    return (int(seed) * 1_000_003 + int(stream)) % _SEED_MOD


def dtype_of(config):
    return getattr(torch, config["dtype"])


def merged(config, traffic, key):
    """A section of the configuration updated by the traffic's."""
    out = dict(config.get(key, {}))
    for name, value in traffic.get(key, {}).items():
        if isinstance(value, dict) and isinstance(out.get(name), dict):
            out[name] = {**out[name], **value}
        else:
            out[name] = value
    return out


class System:
    """The model and family of a configuration, built once, and the
    objective and ``bbvi`` call that a traffic mix drives."""

    def __init__(self, config, traffic, seed, device):
        import viabel_torch as vt
        from viabel_torch.models import zoo

        self.vt = vt
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.dtype = dtype_of(config)
        model_kw = dict(config["model"])
        self.model, self.dim = getattr(zoo, model_kw.pop("zoo"))(
            **model_kw, seed=data_seed(seed), device=self.device, dtype=self.dtype)
        family_kw = dict(config["family"])
        self.family_class = family_kw.pop("class")
        self.approx = getattr(vt, self.family_class)(
            self.dim, **family_kw, device=self.device, dtype=self.dtype)
        self.objective_kw = merged(config, traffic, "objective")
        self.bbvi_kw = merged(config, traffic, "bbvi")

    @property
    def num_mc_samples(self):
        return int(self.objective_kw["num_mc_samples"])

    @property
    def stl(self):
        return bool(self.objective_kw.get("use_path_deriv", False))

    def objective(self):
        """A fresh objective on the shared model and family: an escalation
        raises ``num_mc_samples`` on the objective it runs on, and every
        fit starts from the configured count."""
        kw = dict(self.objective_kw)
        cls = getattr(self.vt, kw.pop("class"))
        return cls(self.approx, self.model, kw.pop("num_mc_samples"), **kw)

    def fit(self, generator, n_iters=None, max_time=None):
        """One ``bbvi`` call as the configuration states it."""
        kw = {k: (dict(v) if isinstance(v, dict) else v) for k, v in self.bbvi_kw.items()}
        if n_iters is not None:
            kw["n_iters"] = int(n_iters)
        if max_time is not None:
            kw.setdefault("RAABBVI_kwargs", {})["max_time"] = max(float(max_time), 0.0)
        return self.vt.bbvi(self.dim, objective=self.objective(), generator=generator, **kw)
