"""``datagen/train.py --scenarios --curriculum`` and ``--fleet`` on a mesh
of two ranks (CPU, gloo), and the fleet controllers' agreement.

- Scenarios: each rank runs its own synthetic producer and scenario
  service. The accounting summed over the ranks holds steps x global batch
  rows exactly, and both ranks print the same report, the same curriculum
  updates, space version and weights (each update sums the ranks'
  evidence before it moves the weights).
- Fleet: each rank's controller scales its own producers within the same
  bounds, one decision per tick for all (the example's controller ticks
  every 0.5 s here): both ranks tick as often, end at the same instance
  count within the bounds and print the same scale events.
- The agreement itself, on stub launchers: ranks that see different
  verdicts on clocks of different rates take the same decisions, and
  controller threads stopped at different moments tick as often.
"""

import re
import sys

import pytest

import torch_dist_ranks as W

SPACE = ("easy:half_extent=u(0.8,1.2) / "
         "hard:half_extent=u(0.8,1.2),xy_jitter=g(6,0.5)")
STEPS = 16
BASE = ["--batch", "8", "--shape", "32", "32", "--synthetic-producers", "1"]
FLEET_STEPS = 100


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    # rank 0 sees the bound; rank 1 sees nothing to act on (its verdicts
    # never dominate) on a clock three times as fast
    verdicts = [["producer-bound"] * 4 + ["step-bound"] * 3
                + ["balanced"] * 2, ["balanced"] * 4 + ["idle"] * 5]
    out = W.run_worlds({2: [
        ("example", {"argv": BASE + ["--steps", str(STEPS), "--scenarios",
                                     SPACE, "--curriculum",
                                     "--curriculum-every", "4"],
                     "f32": False}),
        ("example_fleet", {"argv": BASE + ["--steps", str(FLEET_STEPS),
                                           "--fleet", "1:2"]}),
        ("fleet_agreed", {"verdicts": verdicts, "clock_rates": [1.0, 3.0]}),
    ]}, str(tmp_path_factory.mktemp("mesh-loop")), timeout=120)[2]
    for rank in out:
        for name, res in rank.items():
            assert "error" not in res, f"{name}: {res.get('error')}"
    return out


def _lines(text, *keys):
    return [ln for ln in text.splitlines() if any(k in ln for k in keys)]


def test_the_scenario_accounting_sums_over_the_ranks(ranks):
    reps = [r["example"]["scenarios"] for r in ranks]
    assert reps[0] == reps[1]
    rows = sum(s["rows"] for s in reps[0]["scenarios"].values())
    assert rows == STEPS * 8
    assert all(s["fresh"] == s["rows"] for s in reps[0]["scenarios"].values())
    assert set(reps[0]["scenarios"]) == {"easy", "hard"}


def test_both_ranks_publish_the_same_curriculum(ranks):
    texts = [r["example"]["text"] for r in ranks]
    keys = ("curriculum", "scenario space v")
    assert _lines(texts[0], *keys) == _lines(texts[1], *keys)
    updates = _lines(texts[0], "curriculum v")
    assert updates, texts[0]  # the curriculum moved the space
    assert (ranks[0]["example"]["curriculum_weights"]
            == ranks[1]["example"]["curriculum_weights"])
    version = int(re.search(r"scenario space v(\d+)", texts[0]).group(1))
    assert version == len(updates) + 1


def test_the_fleet_holds_one_instance_count(ranks):
    states = [r["example_fleet"]["fleet"] for r in ranks]
    assert states[0]["instances"] == states[1]["instances"]
    assert 1 <= states[0]["instances"] <= 2
    assert states[0]["ticks"] == states[1]["ticks"] > 0
    events = [[(e["action"], e.get("instance")) for e in s["events"]
               if e["action"] in ("scale_up", "scale_down")]
              for s in states]
    assert events[0] == events[1]
    printed = [re.sub(r"'addr': '[^']*'", "", "\n".join(_lines(
        r["example_fleet"]["text"], "fleet"))) for r in ranks]
    assert printed[0] == printed[1] and "(bounds 1:2)" in printed[0]


def test_the_controllers_take_one_decision_per_tick(ranks):
    a0, a1 = (r["fleet_agreed"] for r in ranks)
    assert a0["actions"] == a1["actions"]
    assert a0["events"] == a1["events"]
    assert a0["instances"] == a1["instances"]
    actions = [a for _v, a, _n in a0["actions"]]
    assert "scale_up" in actions and "scale_down" in actions
    assert a0["threaded_ticks"] == a1["threaded_ticks"] > 0
    assert a0["threaded_instances"] == a1["threaded_instances"]


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
