"""Declarative, versioned scenario spaces for domain randomization (copied
from ``blendjax/scenario/space.py``; numpy only, so the same seed draws the
same scenarios and parameters in either package).

A :class:`ScenarioSpace` is what the consumer publishes to its producers
over the duplex channel (:mod:`blendjax_torch.scenario.service`): named
scenarios, each a dict of named simulation parameters drawn from uniform,
gaussian, categorical or mixture distributions, plus mixture weights over
the scenarios. Producers sample from the latest space per batch
(:class:`blendjax_torch.producer.scenario.ScenarioApplicator`), apply the
draw to their scene, and stamp the scenario id and space version into the
message, so the consumer's accounting (:mod:`blendjax_torch.scenario.accounting`)
attributes every row to the distribution that produced it.

The wire form is pickle-free: ``to_wire()`` emits only msgpack-native
values, so a space decodes under ``allow_pickle=False``. Every space has an
integer ``version``; a curriculum update bumps it (:meth:`ScenarioSpace.bump`),
producers ack the version they applied, and frames stamped with an older
version are accounted under that version.

The compact grammar builds small spaces from a string::

    easy:half_extent=u(0.8,1.2) / hard*2:half_extent=u(0.8,1.2),xy_jitter=g(6,0.5)

scenarios separated by ``/``, an optional ``*weight`` after the name, and
per-parameter distributions ``u(lo,hi)``, ``g(mu,sigma)``, ``c(a|b|c)``,
``m(<dist>@w|<dist>@w)`` or a bare number (a constant).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------


class Dist:
    """One named simulation parameter's sampling distribution."""

    kind: str = ""

    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def to_wire(self) -> list:
        raise NotImplementedError

    @staticmethod
    def from_wire(entry) -> "Dist":
        if not isinstance(entry, (list, tuple)) or not entry:
            raise ValueError(f"malformed distribution entry {entry!r}")
        kind = entry[0]
        cls = _DIST_KINDS.get(kind)
        if cls is None:
            raise ValueError(f"unknown distribution kind {kind!r}")
        return cls._from_wire(entry)


class Uniform(Dist):
    kind = "u"

    def __init__(self, lo: float, hi: float):
        self.lo, self.hi = float(lo), float(hi)
        if not self.hi >= self.lo:
            raise ValueError(f"uniform needs hi >= lo, got ({lo}, {hi})")

    def sample(self, rng):
        return float(rng.uniform(self.lo, self.hi))

    def to_wire(self):
        return ["u", self.lo, self.hi]

    @classmethod
    def _from_wire(cls, e):
        return cls(e[1], e[2])

    def __repr__(self):
        return f"u({self.lo}, {self.hi})"


class Gaussian(Dist):
    """Mutable mu/sigma: the curriculum's REINFORCE update writes the
    adapted parameters back in place before re-publishing the space."""

    kind = "g"

    def __init__(self, mu: float, sigma: float):
        self.mu, self.sigma = float(mu), float(sigma)
        if not self.sigma >= 0:
            raise ValueError(f"gaussian needs sigma >= 0, got {sigma}")

    def sample(self, rng):
        return float(rng.normal(self.mu, self.sigma))

    def to_wire(self):
        return ["g", self.mu, self.sigma]

    @classmethod
    def _from_wire(cls, e):
        return cls(e[1], e[2])

    def __repr__(self):
        return f"g({self.mu}, {self.sigma})"


class Choice(Dist):
    """Categorical over arbitrary msgpack-native values (numbers or
    strings), optionally weighted."""

    kind = "c"

    def __init__(self, values, probs=None):
        self.values = list(values)
        if not self.values:
            raise ValueError("categorical needs at least one value")
        if probs is not None:
            probs = [float(p) for p in probs]
            if len(probs) != len(self.values):
                raise ValueError("probs must match values 1:1")
            total = sum(probs)
            if total <= 0:
                raise ValueError("probs must sum > 0")
            probs = [p / total for p in probs]
        self.probs = probs

    def sample(self, rng):
        i = int(rng.choice(len(self.values), p=self.probs))
        return self.values[i]

    def to_wire(self):
        return ["c", list(self.values), self.probs]

    @classmethod
    def _from_wire(cls, e):
        return cls(e[1], e[2] if len(e) > 2 else None)

    def __repr__(self):
        return f"c({self.values})"


class Mixture(Dist):
    """Weighted mixture of component distributions."""

    kind = "m"

    def __init__(self, components, weights=None):
        self.components = list(components)
        if not self.components:
            raise ValueError("mixture needs at least one component")
        if weights is None:
            weights = [1.0] * len(self.components)
        weights = [float(w) for w in weights]
        if len(weights) != len(self.components):
            raise ValueError("weights must match components 1:1")
        total = sum(weights)
        if total <= 0:
            raise ValueError("mixture weights must sum > 0")
        self.weights = [w / total for w in weights]

    def sample(self, rng):
        i = int(rng.choice(len(self.components), p=self.weights))
        return self.components[i].sample(rng)

    def to_wire(self):
        return ["m", [c.to_wire() for c in self.components],
                list(self.weights)]

    @classmethod
    def _from_wire(cls, e):
        return cls([Dist.from_wire(c) for c in e[1]], e[2])

    def __repr__(self):
        return f"m({self.components}, {self.weights})"


class Const(Dist):
    """A fixed value (bare numbers/strings in the grammar)."""

    kind = "k"

    def __init__(self, value):
        self.value = value

    def sample(self, rng):
        return self.value

    def to_wire(self):
        return ["k", self.value]

    @classmethod
    def _from_wire(cls, e):
        return cls(e[1])

    def __repr__(self):
        return f"const({self.value!r})"


_DIST_KINDS = {c.kind: c for c in (Uniform, Gaussian, Choice, Mixture, Const)}


def as_dist(value) -> Dist:
    """Lift a bare number/string to :class:`Const`; pass Dists through."""
    if isinstance(value, Dist):
        return value
    return Const(value)


# ---------------------------------------------------------------------------
# Scenarios and the space
# ---------------------------------------------------------------------------


class Scenario:
    """One named parameter set: ``{param_name: Dist}`` plus a mixture
    weight relative to the other scenarios in the space."""

    def __init__(self, name: str, params: dict, weight: float = 1.0):
        self.name = str(name)
        if not self.name:
            raise ValueError("scenario needs a non-empty name")
        self.params = {str(k): as_dist(v) for k, v in params.items()}
        self.weight = float(weight)
        if not self.weight > 0:
            raise ValueError(f"scenario weight must be > 0, got {weight}")

    def sample(self, rng: np.random.Generator) -> dict:
        return {k: d.sample(rng) for k, d in self.params.items()}

    def gaussian_params(self) -> list:
        """``[(key, Gaussian), ...]`` in declaration order — the
        continuous parameters the curriculum's score-function update
        adapts, and the order ``theta`` vectors are stamped in."""
        return [
            (k, d) for k, d in self.params.items()
            if isinstance(d, Gaussian)
        ]

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "weight": self.weight,
            "params": {k: d.to_wire() for k, d in self.params.items()},
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Scenario":
        return cls(
            d["name"],
            {k: Dist.from_wire(v) for k, v in d["params"].items()},
            weight=d.get("weight", 1.0),
        )

    def __repr__(self):
        return f"Scenario({self.name!r}, {self.params}, w={self.weight:.3f})"


class ScenarioSpace:
    """Named scenarios + mixture weights + a monotonic version.

    The one object both ends of the duplex protocol share: the consumer
    owns the authoritative copy (and mutates it through the curriculum),
    producers hold the latest acked replica. ``sample(rng)`` draws one
    scenario by the normalized mixture weights, then each of its params,
    returning ``(name, params, theta)`` where ``theta`` lists the drawn
    values of the scenario's Gaussian params in declaration order — the
    score-function update's sample vector, stamped alongside the
    scenario id so the consumer can run REINFORCE without a second
    channel.
    """

    def __init__(self, scenarios, version: int = 1):
        scenarios = list(scenarios)
        if not scenarios:
            raise ValueError("a ScenarioSpace needs at least one scenario")
        self.scenarios = {s.name: s for s in scenarios}
        if len(self.scenarios) != len(scenarios):
            raise ValueError("scenario names must be unique")
        self.version = int(version)

    # -- structure ------------------------------------------------------------

    @property
    def names(self) -> tuple:
        return tuple(self.scenarios)

    def weights(self) -> dict:
        """Normalized mixture weights ``{name: w}`` (sum to 1)."""
        total = sum(s.weight for s in self.scenarios.values())
        return {n: s.weight / total for n, s in self.scenarios.items()}

    def set_weights(self, weights: dict) -> None:
        """Replace mixture weights (un-normalized ok; missing names keep
        their current weight)."""
        for name, w in weights.items():
            if name not in self.scenarios:
                raise KeyError(f"unknown scenario {name!r}")
            if not w > 0:
                raise ValueError(f"weight for {name!r} must be > 0, got {w}")
            self.scenarios[name].weight = float(w)

    def bump(self) -> int:
        """Advance the version (call before re-publishing a mutation)."""
        self.version += 1
        return self.version

    # -- sampling -------------------------------------------------------------

    def sample(self, rng: np.random.Generator):
        """Draw ``(scenario_name, params_dict, theta_list)``."""
        names = list(self.scenarios)
        w = np.asarray(
            [self.scenarios[n].weight for n in names], np.float64
        )
        name = names[int(rng.choice(len(names), p=w / w.sum()))]
        sc = self.scenarios[name]
        params = sc.sample(rng)
        theta = [float(params[k]) for k, _ in sc.gaussian_params()]
        return name, params, theta

    # -- wire form (msgpack-native; decodes under allow_pickle=False) --------

    def to_wire(self) -> dict:
        return {
            "version": self.version,
            "scenarios": [s.to_wire() for s in self.scenarios.values()],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "ScenarioSpace":
        if not isinstance(d, dict) or "scenarios" not in d:
            raise ValueError(f"malformed scenario-space wire form: {d!r}")
        return cls(
            [Scenario.from_wire(s) for s in d["scenarios"]],
            version=int(d.get("version", 1)),
        )

    # -- the grammar ----------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, version: int = 1) -> "ScenarioSpace":
        """Build a space from the compact CLI grammar (module docstring;
        full reference in docs/scenarios.md)."""
        scenarios = []
        # paren-aware like every other level of the grammar: a '/'
        # inside c(...)/m(...) (asset paths as categorical values) must
        # not split the scenario list
        for chunk in _split_top(str(spec), "/"):
            chunk = chunk.strip()
            if not chunk:
                continue
            head, sep, body = chunk.partition(":")
            if not sep:
                raise ValueError(
                    f"scenario {chunk!r} needs 'name:params' (use "
                    "'name:' for a parameter-less scenario)"
                )
            name, _, wtxt = head.strip().partition("*")
            weight = float(wtxt) if wtxt else 1.0
            params = {}
            for kv in _split_top(body, ","):
                if not kv.strip():
                    continue
                key, eq, val = kv.partition("=")
                if not eq:
                    raise ValueError(
                        f"param {kv!r} in scenario {name!r} needs key=value"
                    )
                params[key.strip()] = _parse_dist(val.strip())
            scenarios.append(Scenario(name.strip(), params, weight=weight))
        if not scenarios:
            raise ValueError(f"empty scenario spec {spec!r}")
        return cls(scenarios, version=version)

    def __repr__(self):
        return (
            f"ScenarioSpace(v{self.version}, "
            f"{list(self.scenarios.values())})"
        )


def _split_top(text: str, sep: str) -> list:
    """Split on ``sep`` outside parentheses (param lists contain commas
    inside ``u(...)``/``g(...)`` calls)."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _entry_weights(entries) -> list | None:
    """``@w`` weights of split ``value[@w]`` entries: None when no
    entry is weighted, else a full weight vector with UNWEIGHTED
    entries defaulting to 1.0 — a mixed spec like ``c(a@0.9|b)`` must
    honor the weights it names, not silently fall back to uniform."""
    if not any(len(e) > 1 for e in entries):
        return None
    return [float(e[1]) if len(e) > 1 else 1.0 for e in entries]


def _parse_scalar(txt: str):
    txt = txt.strip()
    try:
        f = float(txt)
    except ValueError:
        return txt  # bare string (categorical value)
    return int(f) if f.is_integer() and "." not in txt and "e" not in txt.lower() else f


def _parse_dist(txt: str) -> Dist:
    txt = txt.strip()
    if "(" in txt and txt.endswith(")"):
        kind, _, inner = txt.partition("(")
        inner = inner[:-1]
        kind = kind.strip()
        if kind == "u":
            lo, hi = (float(p) for p in _split_top(inner, ","))
            return Uniform(lo, hi)
        if kind == "g":
            mu, sigma = (float(p) for p in _split_top(inner, ","))
            return Gaussian(mu, sigma)
        if kind == "c":
            entries = [_split_top(e, "@") for e in _split_top(inner, "|")]
            values = [_parse_scalar(e[0]) for e in entries]
            return Choice(values, _entry_weights(entries))
        if kind == "m":
            entries = [_split_top(e, "@") for e in _split_top(inner, "|")]
            comps = [_parse_dist(e[0]) for e in entries]
            return Mixture(comps, _entry_weights(entries))
        raise ValueError(f"unknown distribution {txt!r} (u/g/c/m)")
    return Const(_parse_scalar(txt))


__all__ = [
    "Dist", "Uniform", "Gaussian", "Choice", "Mixture", "Const",
    "as_dist", "Scenario", "ScenarioSpace",
]
