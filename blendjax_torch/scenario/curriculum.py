"""Loss-driven scenario curriculum (port of
``blendjax/scenario/curriculum.py``): close the domain-randomization loop.

- Mixture weights (which scenario to render) move by a bandit-style
  multiplicative-weights rule toward the scenarios with high loss (what
  the model finds hard now), with an exploration floor so no scenario
  starves.
- Continuous parameters (each scenario's Gaussian distributions) move by
  REINFORCE on the ``(theta, loss)`` pairs producers stamp beside the
  scenario id, through :class:`blendjax_torch.train.score.GaussianSimParams`,
  toward lower expected loss per scenario.

Every update bumps the space's version and re-publishes it through the
:class:`~blendjax_torch.scenario.service.ScenarioService`. ``frozen=True``
observes and never changes the space (the fixed-mixture leg of an A/B).

The REINFORCE evidence is a few host floats per scenario, so each
scenario's ``GaussianSimParams`` runs on the CPU (``device="cpu"``, by
choice: a round trip to the card per update would buy nothing).
"""

from __future__ import annotations

import numpy as np

from blendjax_torch.scenario.accounting import accounting as default_accounting
from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.metrics import metrics

logger = get_logger("scenario")


class ScenarioCurriculum:
    """Adapt a scenario space from per-scenario training losses.

    - ``space``: the authoritative :class:`ScenarioSpace` (mutated in
      place; every update bumps its version).
    - ``service``: optional :class:`ScenarioService` — updates
      re-publish through it.
    - ``every_steps``: cadence for :meth:`step`-driven updates.
    - ``weight_lr``: multiplicative-weights learning rate (0 disables
      mixture-weight adaptation).
    - ``weight_floor``: per-scenario minimum share of the mixture
      (exploration floor; ``floor * n_scenarios`` must stay < 1).
    - ``param_lr`` / ``baseline_decay``: the REINFORCE update's knobs
      (see :class:`~blendjax_torch.train.score.GaussianSimParams`).
    - ``adapt_params``: set False to adapt weights only.
    - ``min_rows``: scenarios with fewer scored rows in the window are
      held out of that update (their weight is untouched).
    - ``frozen``: observe-only eval mode.
    """

    def __init__(
        self,
        space,
        service=None,
        ledger=default_accounting,
        every_steps: int = 50,
        weight_lr: float = 1.0,
        weight_floor: float = 0.05,
        param_lr: float = 5e-2,
        baseline_decay: float = 0.9,
        adapt_params: bool = True,
        min_rows: int = 8,
        frozen: bool = False,
    ):
        self.space = space
        self.service = service
        self.ledger = ledger
        self.every_steps = max(1, int(every_steps))
        self.weight_lr = float(weight_lr)
        if weight_floor < 0:
            raise ValueError(f"weight_floor must be >= 0, got {weight_floor}")
        # the floors must sum below 1 to leave room for adaptation: on
        # wide spaces the per-scenario default is clamped down instead
        # of raising (20 scenarios x the 0.05 default would sum to 1)
        self.weight_floor = min(
            float(weight_floor), 0.9 / len(space.names)
        )
        self.param_lr = float(param_lr)
        self.baseline_decay = float(baseline_decay)
        self.adapt_params = bool(adapt_params)
        self.min_rows = max(1, int(min_rows))
        self.frozen = bool(frozen)
        self.updates = 0
        self._since = 0
        self._sim: dict = {}  # scenario name -> GaussianSimParams
        # REINFORCE baselines restored from a session snapshot, applied
        # when a scenario's GaussianSimParams is (re)built lazily.
        self._restored_baselines: dict = {}
        self.ledger.declare(space)
        if service is not None and service.version < space.version:
            service.publish(space)

    # -- cadence ----------------------------------------------------------------

    def step(self, n: int = 1):
        """Advance the step counter; runs :meth:`update` every
        ``every_steps`` train steps. Returns the update report when one
        ran, else None."""
        self._since += int(n)
        if self._since < self.every_steps:
            return None
        self._since = 0
        return self.update()

    # -- the update -------------------------------------------------------------

    def update(self):
        """One curriculum update from the accounting window; returns a
        report dict (or None when frozen / no evidence)."""
        if self.frozen:
            # eval mode: leave the window accumulating for reporting
            return None
        # PEEK the evidence first; consume only when an update actually
        # lands. Sub-min_rows windows stay ACCUMULATING either way (a
        # floored low-weight scenario gathers evidence across several
        # windows and eventually re-enters the update), and a no-op
        # cadence (tied losses, one eligible scenario, nothing gaussian
        # to adapt) must not drain the OTHER scenarios' windows — that
        # would bias the eventual first comparison toward whichever
        # side kept its history.
        losses = self.ledger.window_losses(
            reset=False, min_rows=self.min_rows
        )
        eligible = {
            sid: mean for sid, (mean, rows) in losses.items()
            if sid in self.space.scenarios
        }
        if not eligible:
            return None
        moved = {}
        if self.weight_lr > 0 and len(eligible) >= 2:
            moved = self._update_weights(eligible)
        adapted = {}
        if self.adapt_params:
            adapted = self._update_params()
        if not moved and not adapted:
            # nothing changed: bumping + republishing an identical
            # space would be pure version churn — per-version
            # accounting would fragment over versions that never
            # differed — and the untouched windows keep accumulating
            return None
        self.ledger.window_losses(reset=True, min_rows=self.min_rows)
        version = self.space.bump()
        if self.service is not None:
            self.service.publish(self.space)
        else:
            self.ledger.declare(self.space)
        self.updates += 1
        metrics.count("scenario.curriculum_updates")
        metrics.gauge("scenario.space_version", version)
        report = {
            "version": version,
            "losses": {k: round(v, 6) for k, v in eligible.items()},
            "weights": {
                k: round(v, 4) for k, v in self.space.weights().items()
            },
            "params_adapted": adapted,
            "weights_moved": moved,
        }
        logger.info("scenario curriculum update: %s", report)
        return report

    def _update_weights(self, losses: dict) -> dict:
        """Multiplicative weights toward high loss, with an exploration
        floor: ``w_i ∝ w_i * exp(eta * adv_i)`` where ``adv`` is the
        scenario's loss normalized to [-1, 1] across the window, then
        ``w = (1 - K*floor) * w_norm + floor`` so every scenario keeps
        a guaranteed share."""
        names = list(self.space.names)
        w = np.asarray(
            [self.space.scenarios[n].weight for n in names], np.float64
        )
        w = w / w.sum()
        vals = np.asarray(
            [losses.get(n, np.nan) for n in names], np.float64
        )
        seen = ~np.isnan(vals)
        lo, hi = np.nanmin(vals), np.nanmax(vals)
        if not hi > lo:
            return {}  # tied losses: no signal, no move, no version bump
        adv = np.zeros(len(names))
        adv[seen] = 2.0 * (vals[seen] - lo) / (hi - lo) - 1.0
        w = w * np.exp(self.weight_lr * adv)
        w = w / w.sum()
        k = len(names)
        w = (1.0 - k * self.weight_floor) * w + self.weight_floor
        self.space.set_weights(dict(zip(names, w.tolist())))
        return {
            n: round(float(a), 4) for n, a in zip(names, adv) if seen[
                names.index(n)
            ]
        }

    def _update_params(self) -> dict:
        """Per-scenario REINFORCE over the stamped ``(theta, loss)``
        pairs: each scenario's Gaussian params form one diagonal-
        Gaussian ``GaussianSimParams`` whose mu/log_sigma update is
        written back into the space's dists."""
        from blendjax_torch.train.score import GaussianSimParams

        adapted = {}
        for name, sc in self.space.scenarios.items():
            gauss = sc.gaussian_params()
            if not gauss:
                continue
            # peek-then-drain: a scenario short of evidence KEEPS its
            # (bounded) theta ring accumulating for the next cadence
            samples = self.ledger.theta_samples(name, drain=False)
            samples = [
                (t, l) for t, l in samples if len(t) == len(gauss)
            ]
            if len(samples) < max(2, self.min_rows // 4):
                continue
            self.ledger.theta_samples(name, drain=True)
            sim = self._sim.get(name)
            mus = [d.mu for _, d in gauss]
            sigmas = [max(d.sigma, 1e-6) for _, d in gauss]
            if sim is None or len(sim.mu) != len(gauss):
                sim = self._sim[name] = GaussianSimParams(
                    mu=mus, log_sigma=np.log(sigmas),
                    learning_rate=self.param_lr,
                    baseline_decay=self.baseline_decay, device="cpu",
                )
                b0 = self._restored_baselines.pop(name, None)
                if b0 is not None:
                    # resume continuity: the running-mean baseline the
                    # uninterrupted run would carry into this update
                    sim.baseline = float(b0)
            else:
                # the space is the source of truth between updates (a
                # peer may have edited it); resync before stepping
                sim.mu = sim.tensor(mus)
                sim.log_sigma = sim.tensor(np.log(sigmas))
            theta = np.asarray([t for t, _ in samples], np.float32)
            losses = np.asarray([l for _, l in samples], np.float32)
            sim.update(theta, losses)
            new_mu = sim.mu.numpy().astype(np.float64)
            new_sigma = np.exp(sim.log_sigma.numpy().astype(np.float64))
            for (key, dist), mu, sigma in zip(gauss, new_mu, new_sigma):
                dist.mu = float(mu)
                dist.sigma = float(max(sigma, 1e-6))
            adapted[name] = {
                k: [round(float(m), 4), round(float(s), 4)]
                for (k, _), m, s in zip(gauss, new_mu, new_sigma)
            }
        return adapted

    # -- session snapshot (blendjax_torch.checkpoint) -------------------------

    def state_dict(self) -> dict:
        """Session snapshot: the authoritative space (wire form —
        already pickle-free and versioned), the update cadence
        position, and the per-scenario REINFORCE baselines. The
        evidence windows and theta rings live in the LEDGER's snapshot
        (``ScenarioAccounting.state_dict``) — one owner per fact."""
        return {
            "updates": self.updates,
            "since": self._since,
            "space": self.space.to_wire(),
            "baselines": {
                name: float(sim.baseline)
                for name, sim in self._sim.items()
                if sim.baseline is not None
            },
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore IN PLACE: the space object's scenarios/weights/
        version are replaced on the existing instance, so the service,
        ledger, and any producer-side references keep pointing at the
        authoritative copy. When a service is attached the restored
        space re-publishes immediately — producers that outlived the
        consumer (remote fleet) adopt the resumed version on their
        next poll."""
        self.updates = int(d.get("updates", 0))
        self._since = int(d.get("since", 0))
        if "space" in d:
            restored = type(self.space).from_wire(d["space"])
            self.space.scenarios = restored.scenarios
            self.space.version = restored.version
            self.ledger.declare(self.space)
            if self.service is not None:
                self.service.publish(self.space)
        self._sim = {}
        self._restored_baselines = {
            str(k): float(v)
            for k, v in (d.get("baselines") or {}).items()
        }


__all__ = ["ScenarioCurriculum"]
